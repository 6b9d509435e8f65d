"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Drives tinyfusers_tpu_torch's SD1.5 text-to-image path on the card, dense
and with a weight-only int8, fp8 or int4 UNet, its SD3-medium path
(MMDiT, rectified flow), without and with T5-XXL, with seeded random
weights made on the card, from its single-file checkpoint and with its
MMDiT quantized, DiT-XL/2, its SD2.1-v path from a checkpoint file
through the port's CLI, SD1.5 with a ControlNet from a checkpoint
file, DeepCache, FreeU, the hires fix, img2img and inpainting,
SDXL-base from a checkpoint file through the CLI (dense and quantized),
the quantization harness, SD1.5 served by the
continuous-batching engine over 4 slots (dense, and through the quantized
serving tool over an int8 and an int4 UNet), the accuracy harness (CLIP
score and CLIP-FID by a seeded ViT-L/14 scorer of each approximation
against bf16), the engine step's memory by UNet format, and SD1.5
fine-tuned through the two training CLIs' jobs (all of the UNet, and
rank-8 LoRA), SD1.5 on a (data, model) mesh (one NCCL rank, then two
ranks on the one card: tensor-parallel and FSDP, ring attention in the
UNet and the MMDiT, a GPipe MMDiT, the serving engine on a mesh and a
Router over it, Adafactor on the sharded state, an ancestral image and a
ControlNet image on a mesh), ControlNet composed with cached CFG and
DeepCache, the full-geometry checkpoint drill, and holds every
hand-written CUDA kernel of those paths
against its plain PyTorch version. Imports neither jax nor
tinyfusers_tpu. The SD3 models' adaLN-Zero leaves (every block's ``mod``
and the ``final`` layer) are zeros under the JAX init, which would keep
the joint attention's output out of the latents, so a wrong kernel would
not show: they are refilled with seeded non-zero values, as the parity
tests' ``tests/torch_parity.py::random_tree`` fills every leaf.
Phases, one or more lines each:

1. device: name, count, and nvidia-smi's name and power limit;
2. build: the kernels compiled from tinyfusers_tpu_torch/csrc (seconds,
   and ptxas's register, shared-memory and spill report per kernel; a TMA
   + wgmma flash kernel is named with its configuration,
   flash_fwd_wgmma<64-row groups, column groups, columns per warpgroup,
   keys per tile, ring stages>, and takes its shared memory at launch);
3. kernels: each kernel against its plain version at every main-path
   shape (the quant matmuls with int8, fp8 and int4 weights; flash_packed
   also at SD3's two joint-attention shapes with their kv_len and at the
   SD2.1-v UNet's four, flash_bhsd also at the 1024x1024 and 768x768 VAEs'
   mid attention, geglu also at the SD2.1-v UNet's four; flash_packed also
   at DiT-XL/2's 512x512 shape, 16 heads of 72; flash_packed and geglu
   also at the SD1.5 UNet's tensor-parallel shapes at model = 2 (TP2:
   4 heads a rank, half the FF's inner width); the quant matmuls in bf16
   also at SDXL-base's 13 UNet linear shapes and the quantized SD3 MMDiT's
   6, and at the serving engine's 19 batch-8 shapes (M = 4x the batch-2
   rows), from ``unet_quant_launches`` and MMDIT_QUANT_SHAPES), bf16 and
   fp32, with its error and tolerance, its time, the plain version's time,
   the library call's time where one computes the same function (with its
   error against the plain version), for the quant matmuls the dense bf16
   ``F.linear`` time at the same shape (all device times, from CUDA-graph
   replays), and the bound from the shapes and the card's published peaks;
   for each flash row also the kernel variant it ran on and its TFLOP/s
   (bf16 rows of the main paths must run on the TMA + wgmma variants), and
   the flash_packed wrapper's host microseconds per call at SD1.5's 64x64
   self-attention shape; in bf16 also flash_packed at the hires fix's
   three 1024x1024 levels (8 heads of 40, 80 and 160) and SD1.5's shapes at
   batch 1 and SDXL-base's four shapes (10 heads of 64 over 4096 tokens,
   20 over 1024) and the serving engine's four at batch 8 (8 heads of 40 /
   80 over 4096 / 1024 tokens), geglu at the hires levels (SDXL's two shapes among them)
   and at batch 1 (their plain attention, where its fp32 logits would
   pass 4 Gi elements, over chunks of query rows with all keys each, timed
   by events); a [gelu] line counting the bf16 values where ops.gelu_erf
   on the card differs from the CPU, and [repair] lines doing the same for
   the functions repaired to JAX's bf16 arithmetic (sigmoid, silu,
   quick_gelu, gelu_tanh, the VAE's scale_latent / unscale_latent at
   SD1.x's, SDXL's and SD3's constants, ControlNet's scaled at 0.9 and
   1.0), each of which fails the run unless 0 of 65,280 values differ;
   for the quant matmuls in bf16 also the error of a planted rounding
   deviation (int8 / fp8: the scale folded into the bf16 weight; int4:
   two, the weight not rounded to bf16 before the product and the scale
   rounded to bf16 before it), which the tolerance must catch; for each
   quant row the variant, tile and split that
   ``kernels/quant_matmul.py::_plan`` gives it (every bf16 main-path int8,
   fp8 and int4 shape must run on wgmma), its TFLOP/s and its time over
   the library call's and dense cuBLAS's, then each format per image
   (launches x ms) against its library call, dense and its bound over all
   19 shapes and over the M <= 154 ones, over SDXL-base's and over the
   MMDiT's, and per serving tick over the engine's batch-8 shapes; every
   attention and quant row is
   also held to a per-row limit (the worst row's relative error);
4. unet: one full-width SD1.5 UNet forward at 256x256 (32x32 latents, so
   the 1024-token level takes the packed kernel) in fp32 on the card,
   against the same weights on the CPU: dense (every FF through the GEGLU
   kernel), then with int8 and with int4 weights (184 quant-matmul
   launches, no GEGLU);
4v. unet-sd21: the same for the full-width SD2.1 UNet (64-wide heads,
   context 1024): 10 flash_packed launches with 5 heads at the 1024-token
   level, 16 GEGLU;
4s. mmdit: one full-width SD3-medium MMDiT forward at a 64x64 latent
   (1024 image + 77 text tokens, padded to 1152 joint tokens, kv_len
   1101: 24 flash_packed launches) in fp32 on the card, against the same
   weights on the CPU;
4d. dit: DiT-XL/2 in fp32 on the card against the CPU at 256x256 (28
   blocks, 256 tokens: the math route, no kernel) and at 512x512
   (``input_size=64``, 1000 classes: one fp32 flash_packed launch a block
   at 16 heads of 72), 28 blocks each; then in bf16 one CFG forward
   (batch 2) with its launches checked exactly (28
   flash_packed on wgmma at 512x512, 0 at 256x256), ms a forward over
   DIT_FORWARDS forwards, and 3 forwards under ``torch.profiler``;
4e. vit: the CLIP scorer's ViT-L/14 (``models/clip_vision.py``, seeded,
   fp32) on 4 uint8 512x512 images through ``preprocess`` (the antialiased
   resize to 224x224), card against CPU: the embeddings and the pixels, no
   kernel launched (257 tokens take the math route); then one 16-image
   batch of preprocess + tower timed by events over 5;
5. main path: ``generate`` at SD1.5 512x512, 20-step DDIM, CFG 7.5, bf16,
   batch 1: one warm-up through the pipeline's stages (finite latents),
   then one image with the launch counts set to 0 just before it and read
   just after (exactly 400 flash_packed on the wgmma variant, 1 flash_bhsd
   on wgmma_wide, 320 geglu, each at a shape that phase 3 measured), then
   two more images (every later image path times PATH_IMAGES = 1, the
   counted one); seconds per
   image by the host clock after synchronize, and peak device memory;
5p. parallel: [parallel-1] the same image through ``generate(mesh=)`` on
   a one-rank NCCL (data 1, model 1) mesh, equal to phase 5's bit for bit
   with the same launches by shape; [parallel-tp2] two ranks on the one
   card (``parallel_rank``; gloo over CUDA tensors, since NCCL takes one
   rank per device): the full-width SD1.5 UNet at model = 2 in fp32
   (allclose atol 2e-4, rtol 2e-3) and bf16 (relative error within twice
   the unsharded bf16 UNet's own against fp32), one tensor-parallel train
   step (data 1 x model 2) and one FSDP step (data 2 x model 1) at full
   width in fp32 against the unsharded step (loss and grad norm within
   rtol 2e-4, every parameter within rtol 2e-3, atol 2e-5; rank 1's
   replicated leaves, loss and grad norm held to rank 0's alike), each rank's
   launches counted exactly per part (20 flash_packed and 16 geglu a
   forward, twice a step with remat) at shapes phase 3 measured (its TP2
   rows: 4 heads and half the FF columns of each rank); on the same two
   ranks [parallel-adafactor] (the same TP and FSDP steps with
   ``optim.adafactor``, its statistics reduced over the shards, held alike
   to the unsharded Adafactor step, and each leaf's update within
   ADA_UPDATE_TOL of the unsharded update's norm), [parallel-gen] (an SD1.5 512x512
   GEN_STEPS-step euler_ancestral bf16 image at batch 2 through
   ``generate(mesh=, generator=)`` on (data 2, model 1): every noise draw of
   a rank its row of the one-device draw bit for bit, the image's mean
   level error against the one-device fp32 call within twice the
   one-device bf16 call's), [parallel-cn] (an SD1.5 + ControlNet 512x512
   CN_STEPS-step fp32 image at model 2, the ControlNet split by
   ``shard_params`` as the UNet, within 1 of 255 of the unsharded image),
   [parallel-ring] (an SD1.5 512x512 fp32 image through
   ``generate(mesh=)`` with ``self_attn_impl="ring:model"`` on (data 1,
   model 2), within 1 of 255 of the unsharded image; SD3-medium's MMDiT at
   1024x1024 with ``attn_impl="ring:model"``, fp32 allclose atol 2e-4 rtol
   2e-3 and bf16 within twice the plain bf16 forward's own error against
   fp32; each rank projects its half of the tokens only), [parallel-pipe]
   (the MMDiT placed over a two-stage pipe, each rank holding half of the
   blocks, with ``pipeline_microbatches=2``: fp32 within 1e-5, bf16 as
   above) and [serve-mesh] (the SD1.5 Engine over 4 slots on (data 2,
   model 1) and (data 1, model 2), three requests of 2 / 3 / 2 steps, equal
   on both ranks bit for bit: in fp32 within 1 level of the one-device
   engine on under 2% of an image's pixels; in bf16, as served, its mean
   level error against the one-device fp32 engine within twice the
   one-device bf16 engine's, beside the witness of the one-device bf16
   engine at 2 slots against 4; then a Router over the fp32 (data 2) one
   and a local one-slot engine, 0 failures),
   each rank's launches counted exactly per part at shapes phase 3
   measured (the microbatch-1 joint row, the engine's TP2 rows); wall
   seconds of each part, of each new group and of the phase;
6. profile: one more image of the same model and inputs under
   ``torch.profiler``: its host seconds, the summed device time, the
   device's busy share, the number of device kernels, the device time
   by kernel group (the port's kernels, cuDNN convolution, cuBLAS,
   reductions, elementwise, other), and (for this image and phase 5n's
   ControlNet image) the eight host ops with the most self CPU time
   (calls, ms);
5q. quantized main path: the same UNet weights restored dense on the card
   and quantized there by ``io/quantize_tree.quantize_params`` to int8,
   fp8 and int4 in turn; for each a warm-up (latents compared with the
   dense ones), one image with the counts checked exactly (3,680 quant
   matmuls at the 19 shapes of phase 3, all on the wgmma variant, 0
   geglu, 400 flash_packed, 1 flash_bhsd); s/image, peak
   and held device memory; for int8 also the bias casts per image that
   the wgmma variant's reading of a bf16 bias leaves out;
6q. profile: one int8 and one int4 image under ``torch.profiler``, as
   phase 6;
5s. SD3 main path: ``sd3.generate`` at SD3-medium without T5, 1024x1024,
   28-step Euler rectified flow, CFG 5.0, bf16, batch 1: a warm-up through
   the pipeline's stages (finite latents), one image with the counts
   checked exactly (672 flash_packed at (2, 4224, 4224, 1536, 24, kv_len
   4173), 1 flash_bhsd at (1, 16384, 16384, 512), no geglu or quant
   matmul; the flash calls on the wgmma variants); s/image, held and
   peak device memory;
6s. profile: one more SD3 image under ``torch.profiler``, as phase 6;
5t. SD3-medium with T5-XXL: one warm-up and one counted image (672
   flash_packed at (2, 4352, 4352, 1536, 24, kv_len 4250), 1 flash_bhsd);
   s/image and memory;
5sf. SD3 from its single file: [ckpt-sd3] SD3-medium seeded on the card
   in bf16 (adaLN leaves refilled) with a seeded learned 192x192 pos_embed
   grid, written by ``state_map.sd3_state_from_params`` as SD3's
   single-file layout (about 6 GB) and read back by
   ``checkpoints.load_sd3_params``: every tensor of the file bit for bit,
   the pos_embed as the centre 64x64 of the stored grid, the pre-only
   block's unreachable leaves zero; the file's size, save and load
   seconds; [main-sd3-file] a warm-up and one counted 1024x1024 28-step
   image of the loaded model (672 flash_packed); [t5-map] T5-XXL's map at
   full width in memory, ``t5_to_state`` then ``t5_from_state``, bit for
   bit;
5sq. the quantized MMDiT through ``tools/sd3_bench_torch.py``'s job (the
   JAX tool's fill): dense, int8 and int4 in turn, a warm-up's latents
   (compared with dense's), one image counted exactly (196
   quant launches at the MMDiT's 6 shapes on wgmma, 672 flash_packed, 1
   flash_bhsd); s/image, held and peak memory, s/image over dense's;
5c. SD2.1-v checkpoint: the model seeded on the card in bf16, written by
   ``io/checkpoints.save_sd_checkpoint`` as fp16 safetensors to a
   temporary directory and read back by ``load_sd_params``; every
   parameter must equal the seeded one after the same fp16 round trip, bit
   for bit; the file's size and the seconds to save and to load;
5v. SD2.1-v main path (OpenCLIP-H penultimate conditioning, 64-wide UNet
   heads, v-prediction) at 768x768 through the CLI's own code
   (``examples/txt2img_torch.py``: ``build`` of its arguments with
   ``--preset sd21-v --ckpt`` that file, the byte-level tokenizer, 20 steps
   of dpmpp_2m on the Karras ladder, CFG 7.5, rescale 0.7, bf16): a
   warm-up (finite latents), one image with the counts checked exactly
   (400 flash_packed at the four shapes of the 96x96 and 48x48 levels, 1
   flash_bhsd at (1, 9216, 9216, 512), 320 geglu at four shapes, all on
   the wgmma variants and measured in phase 3); s/image,
   held and peak memory; then euler_ancestral and heun latents on the
   ladder schedule, their launches 20 flash_packed and 16 geglu per
   network call (heun: 39 calls, the JAX scan's discarded 40th not made);
6v. profile: one more SD2.1-v image under ``torch.profiler``, as phase 6;
   the checkpoint is deleted after it;
5n. ControlNet: [ckpt-cn] an SD1.5 ControlNet (lllyasviel's cldm_v15
   control_stage_config: SD1.5's encoder widths, a 3-channel hint) seeded
   on the card in bf16, its zero convs and last hint conv refilled with
   seeded values (zeros under the JAX init, which would make it a no-op),
   written as an fp16 ``control_model.*`` safetensors file and read back
   by ``load_controlnet_params`` bit for bit; [unet-cn] one ControlNet +
   UNet step at full width in fp32 at 256x256, card vs CPU (14 flash_packed,
   23 geglu); [main-cn] 512x512 20-step DDIM CFG 7.5 images through the
   CLI's ``build()`` with ``--control-ckpt`` that file and a seeded hint
   tensor (560 flash_packed, 140 at each SD1.5 shape; 460 geglu; 1
   flash_bhsd), and a [profile] line of one; [cn-compose]
   (``tools/controlnet_compose_bench_torch.py``'s four modes on that
   ControlNet with the tool's gates, checkerboard hint and scale: exact,
   cached CFG u = 2, DeepCache k = 2, both; the tool's ``run_modes``: a
   warm-up and one counted image each, launches from build_plan, s/image
   and PSNR against the exact controlled image);
5d. DeepCache and FreeU through the same job: [main-deepcache] interval 3,
   split 3; [main-deepcache-cfg] the same with cached CFG interval 2 (the
   branches apart at batch 1: the B=1 shapes of phase 3); [main-freeu]
   (1.5, 1.6, 0.9, 0.2); each with finite latents and launches counted
   from the call counter (full and shallow passes from build_plan);
5h. the hires fix: 512x512 base, latent x2, strength 0.6, 12 tail steps
   at 1024x1024 (flash_packed 400 at SD1.5's shapes and 60 at each of the
   six hires shapes, 120 of them d = 160 on wgmma_wide; 1 flash_bhsd at
   (1, 16384, 16384, 512); geglu 512) and a [profile] line of one image;
5i. img2img (15 of 20 steps; VAE encode and decode: 2 flash_bhsd) and
   inpainting (``unet.SD15_INPAINT_CONFIG``, runwayml's
   v1-inpainting-inference.yaml, in_channels 9; right half masked; the
   kept half equal to the source bit for bit) at 512x512;
   [ckpt-drill] ``tools/ckpt_drill_torch.py --steps DRILL_STEPS``: the
   full-geometry SD1.5 state (1.066 B parameters, fp16) written as
   .safetensors and as a torch-zip .ckpt, each read back through
   ``load_sd_params`` bit for bit after fp16 -> bf16 and run through the
   CLI in a child: load seconds, wall seconds, the child's peak host RSS;
   each image phase prints s/image, held and peak memory, the launches by
   wrapper, by shape and by variant (every shape measured in phase 3);
5e. serving (``serve/engine.py`` over the native scheduler core, 4 slots, a
   fresh SD1.5 bf16 model, ids 49406 then 49407 padding, CFG 7.5): a
   4-step warm-up request, then [serve] 12 requests of 20 / 30 / 25 DDIM
   steps in turn (seeds 0-11), one submitted a tick, run until idle: the
   launches checked exactly (20 flash_packed a tick with an active slot,
   all on wgmma at the four batch-8 shapes of phase 3; 16 geglu a tick; 1
   flash_bhsd a request). The slot step is replayed from the engine's CUDA
   graph, so flash_packed and geglu count as the calls its capture made
   (checked against one UNet pass) times its replays (one a tick with an
   active slot, no eager step); 4 more replayed ticks under the
   profiler, after one that lets it settle, count each replay's kernels
   by name, matched to its graph launch (20 flash_fwd, 16 geglu_ff).
   Then images/s, wall seconds, ticks,
   submit -> result p50 / p95 (``utils/profiling.StepMetrics``), the first result, held and
   peak memory, model TFLOP/s (``utils/flops``) and the device's busy share
   over 4 profiled ticks, and the conv shapes the engine runs one row at a
   time (``ops.conv.RowInvariance``); [serve-join] the request of seed 6,
   which joined a busy engine in slot 2, run alone in the idle engine (slot
   0): the same uint8 image bit for bit; [serve-sync] every tick of 10 two-step requests (admissions
   and encodes staged inside a tick included) under
   ``torch.cuda.set_sync_debug_mode("error")``; [serve-router] a Router over
   the 4-slot engine and a 1-slot one with one injected failure: every
   request completes, ``health()`` counts 1 failure, the same engine and
   buffers are reused;
4x. unet-sdxl: the full-width SDXL UNet (ADM 2816, context 2048) in fp32
   with a random ADM vector at a 64x64 latent, batch 1, on the card
   against the CPU (20 flash_packed at its 32x32 level, 70 geglu);
5x. SDXL-base: [ckpt-sdxl] the model seeded on the card in bf16, written
   by ``io/checkpoints.save_sdxl_checkpoint`` (about 7 GB) to a temporary
   directory after checking its free space, read back through the CLI's
   ``build()`` with ``--preset sdxl --ckpt`` bit for bit; [main-sdxl] a
   warm-up and one 1024x1024 20-step DDIM CFG 7.5 image with its counts
   checked exactly (2,800 flash_packed: 200 / 200 / 1,200 /
   1,200 at the four SDXL shapes; 1,400 geglu: 200 / 1,200; 1 flash_bhsd
   at (1, 16384, 16384, 512));
6x. profile: one more SDXL image under ``torch.profiler``, as phase 6;
5xq. SDXL-base quantized: the CLI's job from the same file with ``--quant
   int8``, ``fp8`` and ``int4`` (``quantize_params`` on the UNet after
   loading), a warm-up and one image each with its counts checked exactly
   (14,420 quant launches at SDXL-base's 13 shapes on wgmma, 2,800
   flash_packed, 1 flash_bhsd, 0 geglu); s/image, held and peak memory;
5qe. quant-eval: ``tools/quant_eval_torch.py --preset sd15 --quant
   int8|fp8|int4`` (seeded bf16 weights): the eps errors at t = 981, 501,
   21, the image PSNR, the largest pixel change, the changed share;
5ae. accuracy: ``tools/accuracy_eval_torch.py --preset sd15 --prompts 2
   --variants int8,fp8,int4,cached_cfg,deepcache`` (seeded SD1.5 bf16,
   seeded ViT-L/14 scorer, TF32 off): each variant's 4 images with their
   launches counted exactly (bf16: 400 flash_packed, 320 geglu, 1
   flash_bhsd an image; int8 / fp8 / int4: 3,680 quant launches at the 19
   shapes, no geglu; cached CFG: 27 batch-1 UNet calls; DeepCache: 7 full
   and 13 shallow passes), every per-image CLIP score in [-100, 100], every
   FID >= 0, PSNR against the bf16 images > 5 dB; the report's rows;
5eq. quantized serving: ``tools/serve_quant_bench_torch.py``'s job over a
   fresh dense, int8 and int4 SD1.5 model, 4 slots, a 4-step warm-up, then
   12 requests of 20 steps submitted together (60 ticks): the launches
   checked exactly (20 flash_packed a tick; 184 quant launches a tick at
   the 19 batch-8 shapes of phase 3, on wgmma; 16 geglu a tick dense; 1
   flash_bhsd a request; the replayed ones as in [serve], with 2 more
   replayed ticks under the profiler counted by kernel name against the
   capture), images/s, wall, p50 / p95, held memory;
   [serve-join] over the int4 engine: a request that joins two busy slots
   (slot 2) against itself alone (slot 0), bit for bit;
5mf. memory: ``tools/memory_footprint_torch.py --preset sd15 --slots 4``:
   the engine step's argument (UNet, slot buffers, control block), output
   and temporary (allocator peak over one tick, and the CUDA graph's
   pool) MB by format, argument
   strictly fp16 > int8 > int4;
3g. [train-grad] (in phase 3): flash_packed at the training step's four
   batch-4 shapes and flash_bhsd at the 512x512 VAE's, geglu at the
   training step's four (M, K, N), bf16 and fp32: the gradients through
   the kernels' autograd Functions (``flash_packed_diff``,
   ``flash_bhsd_diff``, ``geglu_matmul_diff``: the kernel forward, one
   launch each) against autograd through the plain versions, with the
   tolerance (GRAD_TOL); phase 3 itself also times flash_packed and geglu
   at those shapes;
5f. training: [train-grad-unet] the full-width SD1.5 UNet in fp32 at
   batch 1 on a 64x64 latent, every parameter's gradient with the kernels
   (20 flash_packed, 16 geglu) against the same model with the plain
   versions in their place, per tensor within UNET_GRAD_TOL, every
   parameter with a finite non-zero gradient; [train] the job of
   ``examples/train_full_torch.py --preset sd15 --batch 4 --optimizer adamw
   --remat`` (bf16, seeded synthetic pairs): a warm-up step, then 5 steps
   with the launches checked exactly (40 flash_packed and 32 geglu a step,
   remat running each forward twice, at the phase-3 training shapes, on the
   wgmma variants), finite losses and gradient norms, steps/s and
   samples/s, the first step's seconds, held and peak memory, the
   optimizer state's bytes and one profiled step's busy share;
   [train-overfit] 10 steps on one batch with t and noise fixed: the loss
   must fall (the last below the first, the last five's mean below the
   first five's); [train-resume] that job's train
   state written by ``train.save_train_state`` (the JAX package's keys and
   layouts) and read back bit for bit; [train-lora] the same for
   ``examples/train_lora_torch.py`` (rank 8 over a frozen bf16 base, no
   remat: 20 flash_packed and 16 geglu a step) and [train-lora-overfit],
   with every base tensor unchanged bit for bit;
7. the ``kernels`` JSON line: per kernel the main paths' launches (for
   the quant matmuls, those of the quantized images; flash_packed's SD3
   calls, the counterpart of the TPU's multi-k kernel, as their own
   entry; the SDXL image's under the path "sdxl", the serving run's under
   "serve", the fine-tunes' steps under "train" and "train_lora", one DiT
   forward's under "dit_256" / "dit_512", the quantized SD3 and SDXL
   images' under "sd3_int8", "sdxl_fp8" and so on, the accuracy harness's
   under "accuracy_fp16", "accuracy_int4" and so on, the quantized serving
   tool's under "serve_fp16", "serve_int8", "serve_int4"), and per
   shape the launches counted there beside the per-call
   times of phase 3; the per-image times are those counts times those
   per-call times. Then the whole run's seconds, nvidia-smi's line again,
   then the last line ``{"ok": true, ...}``.

A [time] line after each group of phases gives the seconds since the
start. Any failed phase exits non-zero before the last line. Without a CUDA
GPU, or without the repository beside it, it exits non-zero at once.

fp32 comparisons are exact fp32: TF32 is switched off for matmuls and
cuDNN convolutions (torch.backends.*.allow_tf32 = False) for the whole run.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published dense peaks (NVIDIA data sheet), for the bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# The TMA + wgmma flash variants: every bf16 main-path call runs on one.
WGMMA = ("wgmma", "wgmma_wide")

STEPS = 20
GUIDANCE = 7.5
# SD2.1-v through the CLI (examples/txt2img_torch.py): 20 steps of
# DPM-Solver++(2M) on the Karras ladder, CFG 7.5 rescaled by 0.7.
SD21_ARGV = ["--preset", "sd21-v", "--fallback-tokenizer", "--sampler", "dpmpp_2m",
             "--schedule", "karras", "--cfg-rescale", "0.7", "--steps", str(STEPS),
             "--guidance", str(GUIDANCE), "--seed", "4",
             "--prompt", "a photograph of an astronaut riding a horse"]
# SDXL-base through the CLI, from the checkpoint phase 5x writes: the CLI's
# defaults (20 DDIM steps, CFG 7.5), both towers' ids padded with EOT.
SDXL_ARGV = ["--preset", "sdxl", "--fallback-tokenizer", "--steps", str(STEPS),
             "--guidance", str(GUIDANCE), "--seed", "44",
             "--prompt", "a lighthouse on a cliff at dawn, watercolor"]
# SD1.5 through the CLI (seeded random weights), for the ControlNet,
# DeepCache, FreeU and hires-fix images.
SD15_ARGV = ["--preset", "sd15", "--fallback-tokenizer", "--steps", str(STEPS),
             "--guidance", str(GUIDANCE), "--seed", "5",
             "--prompt", "a house in the woods, oil painting"]
SD3_STEPS = 28
SD3_GUIDANCE = 5.0

# (label, call shape as the wrapper counts it): every bf16 flash-attention
# shape of the main paths. flash_packed: (B, Sq, Sk, H*d, H, real keys).
# The SD1.5 UNet's calls (the TPU's single-k-block kernel) ...
PACKED_SHAPES = [("64x64 self", (2, 4096, 4096, 320, 8, 4096)),
                 ("64x64 cross", (2, 4096, 77, 320, 8, 77)),
                 ("32x32 self", (2, 1024, 1024, 640, 8, 1024)),
                 ("32x32 cross", (2, 1024, 77, 640, 8, 77))]
# ... and SD3's joint attention (the TPU's multi-k kernel): 4096 image + 77
# CLIP (+ 77 T5) tokens, padded to a multiple of 128.
MULTIK_SHAPES = [("SD3 joint", (2, 4224, 4224, 1536, 24, 4173)),
                 ("SD3+T5 joint", (2, 4352, 4352, 1536, 24, 4250)),
                 # [parallel-pipe]: the pipelined MMDiT's microbatches of 1
                 ("SD3 joint microbatch 1", (1, 4224, 4224, 1536, 24, 4173))]
# ... and the SD2.1-v UNet's at 768x768: 64-wide heads, 5 at the 96x96
# level and 10 at 48x48 (its 24x24 level, 576 tokens, takes the math route).
SD21_PACKED_SHAPES = [("SD2.1 96x96 self", (2, 9216, 9216, 320, 5, 9216)),
                      ("SD2.1 96x96 cross", (2, 9216, 77, 320, 5, 77)),
                      ("SD2.1 48x48 self", (2, 2304, 2304, 640, 10, 2304)),
                      ("SD2.1 48x48 cross", (2, 2304, 77, 640, 10, 77))]
# ... and the hires fix's tail (SD1.5 at 2x: 1024x1024, 128x128 latents):
# 8 heads of 40, 80 and 160 wide, the last on the wgmma_wide variant.
HIRES_PACKED_SHAPES = [("hires 128x128 self", (2, 16384, 16384, 320, 8, 16384)),
                       ("hires 128x128 cross", (2, 16384, 77, 320, 8, 77)),
                       ("hires 64x64 self", (2, 4096, 4096, 640, 8, 4096)),
                       ("hires 64x64 cross", (2, 4096, 77, 640, 8, 77)),
                       ("hires 32x32 self", (2, 1024, 1024, 1280, 8, 1024)),
                       ("hires 32x32 cross", (2, 1024, 77, 1280, 8, 77))]
# ... and SD1.5's at batch 1: DeepCache with cached CFG runs the cond and the
# uncond branch apart.
B1_PACKED_SHAPES = [("B=1 64x64 self", (1, 4096, 4096, 320, 8, 4096)),
                    ("B=1 64x64 cross", (1, 4096, 77, 320, 8, 77)),
                    ("B=1 32x32 self", (1, 1024, 1024, 640, 8, 1024)),
                    ("B=1 32x32 cross", (1, 1024, 77, 640, 8, 77))]
# ... and SDXL-base's at 1024x1024 (128x128 latents; its 128x128 level has
# no attention): 64-wide heads, 10 over the 64x64 level's 4096 tokens and
# 20 over the 32x32 level's 1024.
XL_PACKED_SHAPES = [("SDXL 64x64 self", (2, 4096, 4096, 640, 10, 4096)),
                    ("SDXL 64x64 cross", (2, 4096, 77, 640, 10, 77)),
                    ("SDXL 32x32 self", (2, 1024, 1024, 1280, 20, 1024)),
                    ("SDXL 32x32 cross", (2, 1024, 77, 1280, 20, 77))]
# ... and the serving engine's (serve/engine.py): SD1.5's UNet at the 2S rows
# of S = 4 slots, [uncond ‖ cond].
SERVE_PACKED_SHAPES = [("serve 64x64 self", (8, 4096, 4096, 320, 8, 4096)),
                       ("serve 64x64 cross", (8, 4096, 77, 320, 8, 77)),
                       ("serve 32x32 self", (8, 1024, 1024, 640, 8, 1024)),
                       ("serve 32x32 cross", (8, 1024, 77, 640, 8, 77))]
SERVE_SLOTS = 4
# [serve-mesh]: tests/multihost_worker.py's three requests, over SERVE_SLOTS
SERVE_MESH_STEPS = (2, 3, 2)
# [parallel-ring]'s SD1.5 image: DDIM steps
RING_STEPS = 2
# serve_demo.py's sd15 step mix, one request a tick, seeds 0-11
SERVE_MIX = [20, 30, 25]
SERVE_REQUESTS = 12
# tools/accuracy_eval_torch.py at SD1.5: prompts, and its variants after bf16
ACC_PROMPTS = 2
ACC_VARIANTS = ["int8", "fp8", "int4", "cached_cfg", "deepcache"]
# tools/serve_quant_bench_torch.py's formats (dense first: the same schedule)
SERVE_QUANT = ["fp16", "int8", "int4"]
# the CLIP scorer's ViT-L/14 (fp32): images card vs CPU, and a timed batch
VIT_CHECK_IMAGES, VIT_BATCH = 4, 16
# The plain attention's fp32 logits of one call: above this many elements
# (4 GiB) it runs over query-row chunks of half as many, all keys each
# (rows are independent: the same function, all rows held).
PLAIN_LOGITS = 1 << 30
# flash_bhsd: (batch * heads, Sq, Sk, d), the VAEs' mid attention.
# ... and DiT-XL/2's at 512x512 (64x64 latents, 1024 tokens): 16 heads of 72,
# whose rows start 144 bytes apart (at 256x256, 256 tokens take the math route).
DIT_PACKED_SHAPES = [("DiT-XL/2 512x512 self", (2, 1024, 1024, 1152, 16, 1024))]
DIT_FORWARDS = 10     # timed bf16 CFG forwards of DiT-XL/2 at each size
SD3_FILE_GRID = 192   # the learned pos_embed grid of SD3-medium's single file
BHSD_SHAPES = [("VAE mid 512x512", (1, 4096, 4096, 512)),
               ("VAE mid 1024x1024", (1, 16384, 16384, 512)),
               ("VAE mid 768x768", (1, 9216, 9216, 512))]

# (M, K, N) of the SD1.5 UNet's linears at bf16, CFG batch 2, and their
# launches in one 20-step image: 184 per forward, 3,680 per image. Every
# one runs the int4 kernel's wgmma variant (g = 64).
QUANT_SHAPES = {
    (8192, 320, 320): 600, (154, 768, 320): 200, (8192, 320, 2560): 100,
    (8192, 1280, 320): 100, (2048, 640, 640): 600, (154, 768, 640): 200,
    (2048, 640, 5120): 100, (2048, 2560, 640): 100, (512, 1280, 1280): 600,
    (154, 768, 1280): 240, (512, 1280, 10240): 100, (512, 5120, 1280): 100,
    (128, 1280, 1280): 120, (128, 1280, 10240): 20, (128, 5120, 1280): 20,
    (2, 1280, 320): 100, (2, 1280, 640): 100, (2, 1280, 1280): 260,
    (2, 320, 1280): 20}
# (label, (M, K, N), launches in one 20-step image): the SD1.5 UNet's FF
# tails at bf16, CFG batch 2, 16 per forward. Phase 5 fails if the main
# path gives geglu a shape not listed.
GEGLU_SHAPES = [("64x64", (8192, 1280, 320), 100),
                ("32x32", (2048, 2560, 640), 100),
                ("16x16", (512, 5120, 1280), 100),
                ("8x8 mid", (128, 5120, 1280), 20)]
# ... and the SD2.1-v UNet's at 768x768 (its main path, phase 5v).
SD21_GEGLU_SHAPES = [("SD2.1 96x96", (18432, 1280, 320), 100),
                     ("SD2.1 48x48", (4608, 2560, 640), 100),
                     ("SD2.1 24x24", (1152, 5120, 1280), 100),
                     ("SD2.1 12x12 mid", (288, 5120, 1280), 20)]
# ... and the hires tail's (the 16x16 mid block's is SD1.5's 16x16 shape; the
# last two are also SDXL-base's two, 200 and 1,200 launches an image) ...
HIRES_GEGLU_SHAPES = [("hires 128x128", (32768, 1280, 320), 60),
                      ("hires 64x64", (8192, 2560, 640), 60),
                      ("hires 32x32", (2048, 5120, 1280), 60)]
# ... and SD1.5's at batch 1 (DeepCache with cached CFG).
B1_GEGLU_SHAPES = [("B=1 64x64", (4096, 1280, 320), None),
                   ("B=1 32x32", (1024, 2560, 640), None),
                   ("B=1 16x16", (256, 5120, 1280), None),
                   ("B=1 8x8 mid", (64, 5120, 1280), None)]
# ... and the training step's (examples/train_full_torch.py and
# train_lora_torch.py at --preset sd15 --batch 4: 64x64 latents, no CFG):
# flash_packed 20 and geglu 16 a UNet forward, twice a step with remat.
TRAIN_BATCH = 4
TRAIN_PACKED_SHAPES = [("train 64x64 self", (4, 4096, 4096, 320, 8, 4096)),
                       ("train 64x64 cross", (4, 4096, 77, 320, 8, 77)),
                       ("train 32x32 self", (4, 1024, 1024, 640, 8, 1024)),
                       ("train 32x32 cross", (4, 1024, 77, 640, 8, 77))]
TRAIN_GEGLU_SHAPES = [("train 64x64", (16384, 1280, 320), None),
                      ("train 32x32", (4096, 2560, 640), None),
                      ("train 16x16", (1024, 5120, 1280), None),
                      ("train 8x8 mid", (256, 5120, 1280), None)]  # B=1 16x16's too
# ... and the SD1.5 UNet's at model = 2 ([parallel-tp2]: each of two ranks
# holds 4 of the 8 heads and half of each FF's inner columns), CFG batch 2 at
# 64x64 latents, as its forward and its tensor-parallel train step give them.
TP2_PACKED_SHAPES = [("TP2 64x64 self", (2, 4096, 4096, 160, 4, 4096)),
                     ("TP2 64x64 cross", (2, 4096, 77, 160, 4, 77)),
                     ("TP2 32x32 self", (2, 1024, 1024, 320, 4, 1024)),
                     ("TP2 32x32 cross", (2, 1024, 77, 320, 4, 77))]
TP2_GEGLU_SHAPES = [("TP2 64x64", (8192, 640, 320), None),
                    ("TP2 32x32", (2048, 1280, 640), None),
                    ("TP2 16x16", (512, 2560, 1280), None),
                    ("TP2 8x8 mid", (128, 2560, 1280), None)]
# ... and the engine's at model = 2 ([serve-mesh] on (data 1, model 2): all
# 2S = 8 rows on each rank, 4 heads and half the FF columns); on (data 2,
# model 1) each rank runs 4 rows, the training step's shapes.
SERVE_TP2_PACKED_SHAPES = [("serve TP2 64x64 self", (8, 4096, 4096, 160, 4, 4096)),
                           ("serve TP2 64x64 cross", (8, 4096, 77, 160, 4, 77)),
                           ("serve TP2 32x32 self", (8, 1024, 1024, 320, 4, 1024)),
                           ("serve TP2 32x32 cross", (8, 1024, 77, 320, 4, 77))]
SERVE_TP2_GEGLU_SHAPES = [("serve TP2 64x64", (32768, 640, 320), None),
                          ("serve TP2 32x32", (8192, 1280, 640), None),
                          ("serve TP2 16x16", (2048, 2560, 1280), None),
                          ("serve TP2 8x8 mid", (512, 2560, 1280), None)]
# [parallel-tp2]'s train steps: fp32, SGD (momentum 0.9 for FSDP, whose
# trace the data ranks split) after global-norm clipping at 1.0
TP2_LR = 1e-2
# [parallel-adafactor]'s steps: optax.adafactor's defaults at this rate; each
# leaf's update (about 1e-3 rms(p) a step, far under the params' tolerance)
# held to the unsharded update within this share of its norm: sums in
# another order give 2.3e-5 on the H100, a mean reduced over too few ranks
# 0.13-0.29
ADA_LR = 1e-3
ADA_UPDATE_TOL = 1e-3
# [parallel-gen]'s euler_ancestral bf16 image at batch 2 and [parallel-cn]'s
# fp32 ControlNet image: steps
GEN_STEPS = 5
CN_STEPS = 2
DRILL_STEPS = 2       # the CLI's steps on each container in [ckpt-drill]
# timed images of each image path after phase 5 (the first with its launches
# counted); phase 5 itself times 3
PATH_IMAGES = 1
TRAIN_STEPS = 5       # timed steps of each training job, after one warm-up step
OVERFIT_STEPS = 10    # steps on one repeated batch, t and noise fixed
# Gradients through the autograd Functions (the kernel forward, the exact-math
# backward) against autograd through the plain versions, ||d|| / ||plain||:
# in bf16 the plain versions round otherwise (q's base-2 prescale in bf16, the
# A-S erf and its rounded product), at most 6.2e-3 (attention) and 3.8e-3
# (GEGLU) on the CPU at these widths; fp32 differs in summation order only.
GRAD_TOL = {torch.bfloat16: 1.5e-2, torch.float32: 1e-5}
# The full-width SD1.5 UNet's parameter gradients in fp32, kernels against
# plain versions, per tensor: summation orders compounded through the network.
UNET_GRAD_TOL = 1e-3
# (M, K, N) -> launches in one SD3-medium 1024x1024 28-step image with the
# MMDiT quantized (tools/sd3_bench_torch.py --quant): the 7 linears outside
# the stacked joint blocks, once per CFG call: the timestep and pooled MLPs
# and the final modulation at M = 2, the context embedding over 2 x 77
# tokens, the final projection over 2 x 4096 image tokens (N = 64).
MMDIT_QUANT_SHAPES = {(2, 256, 1536): 28, (2, 1536, 1536): 56, (2, 2048, 1536): 28,
                      (2, 1536, 3072): 28, (154, 4096, 1536): 28, (8192, 1536, 64): 28}
QUANT_F32 = [(2, 1280, 320), (154, 768, 640), (2048, 640, 640), (512, 5120, 1280)]
# The int4 shapes whose weight bytes, not x's, dominate (the tinygemm regime).
SMALL_M = 154

# Device-kernel name fragments -> group, for the profile phase.
GROUPS = (
    ("quant_mm", "port: quant matmul"),
    ("flash_fwd", "port: flash attention"),
    ("geglu_ff", "port: geglu"),
    ("conv", "convolution (cuDNN)"),
    ("fprop", "convolution (cuDNN)"),  # sm90_xmma_fprop_implicit_gemm...
    ("gemm", "matrix products (cuBLAS)"),
    ("sm90_xmma", "matrix products (cuBLAS)"),
    ("cutlass", "matrix products (cuBLAS)"),
    ("nvjet", "matrix products (cuBLAS)"),  # cuBLAS's Hopper GEMMs
    ("reduce", "reductions (norm statistics)"),
    ("elementwise", "elementwise"),
)


def unet_launches(ucfg, side: int, batch: int, part: str = "all", m: int = 0):
    """(flash_packed launches by call shape, geglu launches by call shape)
    of one pass of ``ucfg``'s UNet at a side x side latent and batch
    ``batch``, from its build_plan: per transformer a self- and a 77-key
    cross-attention where its level has at least 1024 tokens (below, they
    take the math route: ops/attention.py), and one geglu. part "all" is
    the whole UNet, "control" its input blocks and middle (a ControlNet's),
    "shallow" DeepCache's shallow pass at split m (the first m input and
    last m output blocks)."""
    import collections

    from tinyfusers_tpu_torch.models import unet as unet_mod

    inp, mid, outp = unet_mod.build_plan(ucfg)
    flash, geglu = collections.Counter(), collections.Counter()

    def walk(block, s, count):
        for spec in block:
            if isinstance(spec, unet_mod.AttnSpec) and count:
                heads, _ = ucfg.heads_for(spec.ch)
                n = s * s
                for _ in range(spec.depth):
                    if n >= 1024:
                        flash[(batch, n, n, spec.ch, heads, n)] += 1
                        flash[(batch, n, 77, spec.ch, heads, 77)] += 1
                    geglu[(batch * n, 4 * spec.ch, spec.ch)] += 1
            elif isinstance(spec, unet_mod.SampleSpec):
                s = s // 2 if spec.mode == "down" else s * 2
        return s

    s = side
    for i, block in enumerate(inp):
        s = walk(block, s, part != "shallow" or i < m)
    walk(mid, s, part != "shallow")
    if part != "control":
        for j, block in enumerate(outp):
            s = walk(block, s, part != "shallow" or j >= len(outp) - m)
    return dict(flash), dict(geglu)


def unet_quant_launches(ucfg, side: int, batch: int, ctx_len: int = 77) -> dict:
    """(M, K, N) -> launches of the quant matmuls in one pass of ``ucfg``'s
    UNet with quantized weights at a side x side latent and batch ``batch``,
    from its build_plan: the timestep (and ADM) MLPs and each ResBlock's
    embedding projection at M = batch; per transformer block the four
    self-attention and the cross q / out projections over the level's
    tokens, the cross k / v over the context, and the FF's two linears (the
    FF tail takes no GEGLU kernel with a quantized weight). The 1x1 proj_in
    / proj_out convs dequantize: no quant matmul."""
    import collections

    from tinyfusers_tpu_torch.models import unet as unet_mod

    inp, mid, outp = unet_mod.build_plan(ucfg)
    temb = 4 * ucfg.model_channels
    out = collections.Counter({(batch, ucfg.model_channels, temb): 1})
    out[(batch, temb, temb)] += 1
    if ucfg.adm_in_channels:
        out[(batch, ucfg.adm_in_channels, temb)] += 1
        out[(batch, temb, temb)] += 1
    s = side
    for block in [*inp, mid, *outp]:
        for spec in block:
            if isinstance(spec, unet_mod.ResSpec):
                out[(batch, temb, spec.out_ch)] += 1
            elif isinstance(spec, unet_mod.AttnSpec):
                c, m = spec.ch, batch * s * s
                for _ in range(spec.depth):
                    out[(m, c, c)] += 6
                    out[(batch * ctx_len, ucfg.context_dim, c)] += 2
                    out[(m, c, 8 * c)] += 1
                    out[(m, 4 * c, c)] += 1
            elif isinstance(spec, unet_mod.SampleSpec):
                s = s // 2 if spec.mode == "down" else s * 2
    return dict(out)


def launches_of(*parts):
    """Summed launch counts: parts are (times, (flash by shape, geglu by
    shape)) pairs -> (flash by shape, geglu by shape)."""
    flash, geglu = {}, {}
    for times, (f, g) in parts:
        for out, counts in ((flash, f), (geglu, g)):
            for key, n in counts.items():
                out[key] = out.get(key, 0) + times * n
    return ({k: n for k, n in flash.items() if n}, {k: n for k, n in geglu.items() if n})


# A hand-written kernel's family by the wrapper that launches it: its name
# in a profiler trace holds the family, then its variant and template.
KERNEL_FAMILY = {"flash_packed": "flash_fwd", "flash_bhsd": "flash_fwd",
                 "geglu_matmul": "geglu_ff", "quant_matmul": "quant_mm",
                 "quant_matmul_int4": "quant_mm"}


def traced_replays(logdir: str):
    """From the newest Chrome trace under ``logdir`` (a ``profiling.trace``
    block): for each CUDA graph launch (``cudaGraphLaunch`` call), in
    order, the kernels of each KERNEL_FAMILY that it ran, counted by name
    and matched to the launch by correlation id."""
    import collections
    import glob
    import os

    path = max(glob.glob(os.path.join(logdir, "*.json")), key=os.path.getmtime)
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    family = re.compile("(" + "|".join(sorted(set(KERNEL_FAMILY.values()))) + ")_")
    launches = sorted((e for e in events if e.get("name", "").startswith("cudaGraphLaunch")),
                      key=lambda e: e["ts"])
    ran = {e.get("args", {}).get("correlation"): collections.Counter() for e in launches}
    for e in events:
        found = family.search(e.get("name", ""))
        launch = e.get("args", {}).get("correlation")
        if e.get("cat") == "kernel" and found and launch in ran:
            ran[launch][found.group(1)] += 1
    return [dict(ran[e.get("args", {}).get("correlation")]) for e in launches]


def replays_by_name(eng, ids, ticks: int, seed: int):
    """Every slot of ``eng`` busy, then 1 + ``ticks`` replayed ticks under
    ``profiling.trace``: the first lets the profiler settle (a replay
    launched as it starts can lose its first kernels' records), the others
    are counted. -> (each counted replay's kernels by KERNEL_FAMILY, by
    name; one replay of the capture's counts; the graph launches traced)."""
    from tinyfusers_tpu_torch.utils.profiling import trace

    for i in range(eng.S):
        eng.submit(eng.make_request(ids, ids, num_steps=ticks + 3, seed=seed + i))
    eng.step()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            for _ in range(1 + ticks):
                eng.step()
            torch.cuda.synchronize()
        replays = traced_replays(tmp)
    eng.run_until_idle()
    return replays[1:], captured_launches(eng._graph_counts), len(replays)


def captured_launches(graph_counts):
    """One replay of a graph whose capture counted ``graph_counts`` (an
    Engine's, in kernels/counters.COUNTED's order): launches by
    KERNEL_FAMILY."""
    from tinyfusers_tpu_torch.kernels import counters

    out = {}
    for w, (n, _, _) in zip(counters.COUNTED, graph_counts):
        family = KERNEL_FAMILY[w.__name__]
        out[family] = out.get(family, 0) + n
    return {family: n for family, n in out.items() if n}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def say(*a) -> None:
    print(*a, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


@functools.cache
def side_stream() -> torch.cuda.Stream:
    """The one capture stream: cuBLAS keeps a workspace per stream it has
    run on, so a new stream per timing would hold more memory each time."""
    return torch.cuda.Stream()


def cuda_ms(fn, n: int) -> float:
    """Device time of one call: n calls captured in a CUDA graph, warm,
    timed by events around a replay. Eager back-to-back calls would time
    the host's issue rate for the short calls instead (the image's host
    cost is in s/image and the profile)."""
    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm: builds the kernels and sets their attributes
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def wrapper_host_us(fn, calls: int = 200, runs: int = 5) -> float:
    """Host microseconds of one eager wrapper call (launch included): the
    median of ``runs`` runs of ``calls`` calls, no synchronize between."""
    per = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(per)[runs // 2]


def rel_err(got: torch.Tensor, want: torch.Tensor):
    """(max |got - want|, ||got - want|| / ||want||, the largest such
    relative error of one row (last axis; rows of zeros in want skipped))."""
    g, w = got.float(), want.float()
    d = g - w
    rows = w.reshape(-1, w.shape[-1]).norm(dim=1)
    keep = rows > 0
    row = ((d.reshape(-1, d.shape[-1]).norm(dim=1)[keep] / rows[keep]).max().item()
           if keep.any() else 0.0)
    return d.abs().max().item(), (d.norm() / w.norm().clamp_min(1e-30)).item(), row


def bound(flops: float, nbytes: float, dtype) -> tuple:
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def short_kernel_name(mangled: str) -> str:
    """flash_fwd_wgmma<3,1,64,128,2> from ptxas's mangled name (the last
    name of a nested one, the template's integer arguments in order);
    other names as they are."""
    m = re.search(r"_cu_[0-9a-f]{8}(?=\d)", mangled)
    if not m:
        return mangled.strip("'")
    rest = mangled[m.end():]
    while (n := re.match(r"\d+", rest)):
        name, rest = rest[n.end():n.end() + int(n.group())], rest[n.end() + int(n.group()):]
    args = re.findall(r"Li(\d+)E", rest[:rest.find("Ev") + 1])
    return name + (f"<{','.join(args)}>" if args else "")


def int4pack_mm(x, w):
    """torch._weight_int4pack_mm (tinygemm) on the int4 weight ``w`` (an
    Int4Tensor packed on axis 0): (callable, None), or (None, why) where this
    PyTorch build has no CUDA kernel for it. It decodes (q - 8) * scale +
    zero per group of K, so q = nibble ^ 8 and zero = 0 give ((v & 0xF) ^ 8)
    - 8 times the scale; its scales are in x's dtype, and it adds no bias.
    The weight is packed once, here, with even k in the high nibble, as the
    op's input takes it."""
    p = w.packed.t().contiguous()  # (N, K/2), even k in the low nibble
    q = (((p & 0xF) ^ 8) << 4) | ((p >> 4) ^ 8)
    tiles = next((t for t in (8, 4, 2) if w.orig_dim % (16 * t) == 0), 2)
    sz = torch.stack([w.scales, torch.zeros_like(w.scales)], -1).to(x.dtype).contiguous()
    try:
        packed = torch._convert_weight_to_int4pack(q.contiguous(), tiles)
        torch._weight_int4pack_mm(x, packed, w.group_size, sz)
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    return (lambda: torch._weight_int4pack_mm(x, packed, w.group_size, sz)), None


def profile(run, host_ops: bool = False) -> dict:
    """Host seconds of run() and its device kernels' time by group; with
    host_ops, also the eight host ops with the most self CPU time (calls,
    ms), which ``key_averages`` adds seconds to find. The device events are
    read from the profiler's raw kineto events: the same events and
    durations ``prof.events()`` gives, without building the ~10^5 Python
    event objects of an image (tens of seconds each). A host_ops profile
    builds those objects anyway, and there the two readings must agree."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    def by_group(events):  # (name, ms) of each device kernel -> (ms by group, count)
        groups, n = {}, 0
        for name, ms in events:
            label = next((g for key, g in GROUPS if key in name.lower()), "other")
            groups[label] = groups.get(label, 0.0) + ms
            n += 1
        return groups, n

    cuda = torch.autograd.DeviceType.CUDA
    groups, n_kernels = by_group((e.name(), e.duration_ns() / 1e6)
                                 for e in prof.profiler.kineto_results.events()
                                 if e.device_type() == cuda)
    device_ms = sum(groups.values())
    out = {"host_s": host_s, "device_ms": device_ms, "device_kernels": n_kernels,
           "device_busy_share": device_ms / (host_s * 1e3),
           "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}
    if host_ops:  # where the host's time goes: the most self time on the CPU
        check, n_check = by_group((e.name, e.device_time_total / 1e3)
                                  for e in prof.events() if e.device_type == cuda)
        if n_check != n_kernels or check.keys() != groups.keys() or any(
                abs(check[g] - ms) > 1e-6 * max(ms, 1.0) for g, ms in groups.items()):
            fail(f"profile: the raw kineto events ({n_kernels} kernels, {groups}) and "
                 f"prof.events() ({n_check}, {check}) disagree")
        out["events_agree"] = n_check
        top = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CPU),
                     key=lambda e: -e.self_cpu_time_total)[:8]
        out["host_top_ops"] = {e.key: [e.count, round(e.self_cpu_time_total / 1e3, 1)]
                               for e in top}
    return out


def fill_zero_init(model, seed):
    """Seeded non-zero values in every leaf the JAX init leaves at zero
    (the MMDiT's adaLN-Zero linears, a ControlNet's zero convs and last
    hint conv): weights normal / sqrt(fan_in), biases 0.1 normal, as
    random_tree fills them."""
    from tinyfusers_tpu_torch.models.layers import ZeroConv, ZeroLinear

    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for leaf in model.modules():
            if isinstance(leaf, (ZeroLinear, ZeroConv)):
                w = torch.randn(leaf.weight.shape, generator=g, device=dev)
                leaf.weight.copy_(w * leaf.weight[0].numel() ** -0.5)
                leaf.bias.copy_(torch.randn(leaf.bias.shape, generator=g, device=dev) * 0.1)


def sd15_prompt(dev) -> tuple:
    """Phase 5's ids and negative ids, (1, 77) each on ``dev``: BOS, 8 seeded
    tokens and EOS padding; BOS and EOS padding."""
    g_ids = torch.Generator().manual_seed(3)
    ids = torch.full((1, 77), 49407, dtype=torch.long)
    ids[0, 0] = 49406
    ids[0, 1:9] = torch.randint(0, 49406, (8,), generator=g_ids)
    uncond = torch.full((1, 77), 49407, dtype=torch.long)
    uncond[0, 0] = 49406
    return ids.to(dev), uncond.to(dev)


def tp_shapes(counts: tuple, m: int) -> tuple:
    """unet_launches' (flash, geglu) call shapes on a rank of a model axis of
    m: each attention's heads and each FF's inner columns split m ways."""
    flash, geglu = counts
    return ({(b, sq, sk, c // m, h // m, kv): n for (b, sq, sk, c, h, kv), n in flash.items()},
            {(rows, k // m, nn): n for (rows, k, nn), n in geglu.items()})


def engine_launches(ucfg, steps, slots: int, data: tuple, model: int) -> dict:
    """Launches by wrapper on one rank of an Engine over ``slots`` slots
    serving requests of ``steps`` (submitted at once), its slots split over
    data = (n, this rank's index) and its UNet over ``model``: one UNet pass
    at the rank's 2 S / n rows in each tick with a local slot active, one
    VAE decode for each local slot that finishes (the scheduler core's
    simulation, as serve/engine.py ticks it)."""
    from tinyfusers_tpu_torch.serve.engine import _PySchedulerCore

    core = _PySchedulerCore(slots)
    for i, n in enumerate(steps):
        core.submit(i, n)
    local = slots // data[0]
    mine = range(data[1] * local, (data[1] + 1) * local)
    passes = decodes = 0
    while core.active() or core.pending():
        core.assign()
        passes += any(core.remaining(s) > 0 for s in mine)
        decodes += sum(slot in mine for _, slot in core.tick())
    flash, geglu = launches_of((passes, tp_shapes(unet_launches(ucfg, 64, 2 * local), model)))
    return {"flash_packed": sum(flash.values()), "flash_bhsd": decodes,
            "geglu": sum(geglu.values())}


def parallel_rank(rank: int, world: int, store: str, outdir: str) -> None:
    """One of [parallel-tp2]'s two ranks, on the one card, in a gloo group
    over CUDA tensors. Writes <outdir>/rank<rank>.json: for each part its
    launches by wrapper and by call shape and its check: each rank's
    forward against the unsharded one; after a train step each rank's
    replicated leaves, loss and grad_norm against rank 0's, and (rank 0,
    which also runs the dense reference step) the step against the
    unsharded one.

    Parts ([parallel-tp2]): the full-width SD1.5 UNet forward at
    model = 2, fp32 (TF32 off) and bf16, against the unsharded UNet on the
    card; one tensor-parallel train step (data 1 x model 2, the UNet's
    column- and row-parallel Linears split) and one FSDP step (data 2 x
    model 1, the state split over the data ranks, one row each) at full
    width, fp32, against the unsharded step on the global batch.

    [parallel-ring]: an SD1.5 512x512 fp32 image through
    ``generate(mesh=)`` with ``self_attn_impl="ring:model"`` on (data 1,
    model 2) against the unsharded image; SD3-medium's MMDiT at 1024x1024
    with ``attn_impl="ring:model"`` in fp32 and bf16 against the plain
    forward. [parallel-pipe]: the MMDiT placed over a two-stage pipe
    (each rank holds half of the blocks) with ``pipeline_microbatches=2``,
    fp32 and bf16. [serve-mesh]: the SD1.5 Engine over 4 slots on (data 2,
    model 1) and (data 1, model 2) against the one-device engine, in fp32
    and in bf16 (beside the bf16 witness: the one-device engine at 2
    slots), then a Router over the first and a local one-slot engine."""
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    from tinyfusers_tpu_torch import parallel, train
    from tinyfusers_tpu_torch.kernels.flash_attention import flash_bhsd, flash_packed
    from tinyfusers_tpu_torch.kernels.geglu_ff import geglu_matmul
    from tinyfusers_tpu_torch.models import unet as unet_mod
    from tinyfusers_tpu_torch.models.layers import init_weights, set_trainable
    from tinyfusers_tpu_torch.pipeline import sd
    from tinyfusers_tpu_torch.train import optim

    dev = torch.device("cuda:0")
    counted = {"flash_packed": flash_packed, "flash_bhsd": flash_bhsd, "geglu": geglu_matmul}
    out = {}
    cfg = sd.SD15.unet

    def unet(dtype=torch.float32):
        model = unet_mod.UNet(cfg, device=dev, dtype=torch.float32)
        init_weights(model, seed=11)
        return model.to(dtype)

    def start():  # both ranks start a timed part together
        torch.cuda.synchronize()
        dist.barrier()
        for w in counted.values():
            w.launches = 0
            w.shapes.clear()
        return time.perf_counter()

    def seconds_since(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def part(name, what, seconds, want, ok, check):
        out[name] = {"what": what, "seconds": seconds, "want": want,
                     "ok": bool(ok), "check": check,
                     "launches": {kn: w.launches for kn, w in counted.items()},
                     "shapes": {kn: {json.dumps(list(k)): n for k, n in w.shapes.items()}
                                for kn, w in counted.items()}}

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((2, 64, 64, 4), generator=g, device=dev)
    ctx = torch.randn((2, 77, 768), generator=g, device=dev)
    t = torch.full((2,), 981.0, device=dev)
    per_forward = {"flash_packed": 20, "flash_bhsd": 0, "geglu": 16}

    def timed(fn):  # (result, seconds) of a warm call
        fn()
        t0 = start()
        got = fn()
        return got, seconds_since(t0)

    def same_as_rank0(y):
        """Whether this rank's tensor is rank 0's, bit for bit."""
        ref = y.contiguous().clone()
        dist.broadcast(ref, src=0)
        return torch.equal(y, ref)

    def wall(group, t0):  # a group's wall seconds, as rank 0 saw them
        out.setdefault("wall", {})[group] = time.perf_counter() - t0

    mm = {}  # the MMDiT parts' inputs and, on rank 0, the plain forward's outputs

    def mmdit(c):
        from tinyfusers_tpu_torch.models import mmdit as mmdit_mod

        model = mmdit_mod.MMDiT(c, device=dev, dtype=torch.float32)
        init_weights(model, seed=31)
        fill_zero_init(model, seed=32)
        return model

    def mmdit_forward(model, dtype, mesh=None):
        """(output, seconds) of one forward at SD3-medium's 1024x1024 CFG batch;
        without a mesh (rank 0's plain forward) no barrier, no count reset."""
        from tinyfusers_tpu_torch.models import mmdit as mmdit_mod

        model.to(dtype)
        args = (mm["x"].to(dtype), mm["t"], mm["ctx"].to(dtype), mm["pooled"].to(dtype))
        torch.cuda.synchronize()
        t0 = time.perf_counter() if mesh is None else start()
        with torch.inference_mode(), parallel.use_mesh(mesh):
            y = mmdit_mod.apply(model, *args)
        return y, seconds_since(t0)

    def mmdit_refs():
        """The plain SD3-medium MMDiT forward on rank 0, fp32 and bf16."""
        from tinyfusers_tpu_torch.pipeline import sd3

        if mm:
            return mm["cfg"]
        gm = torch.Generator(device=dev).manual_seed(33)
        mm.update(cfg=sd3.SD3_MEDIUM_CFG.mmdit,
                  x=torch.randn((2, 128, 128, 16), generator=gm, device=dev),
                  t=torch.rand((2,), generator=gm, device=dev),
                  ctx=torch.randn((2, 77, 4096), generator=gm, device=dev),
                  pooled=torch.randn((2, 2048), generator=gm, device=dev))
        if rank == 0:
            plain = mmdit(mm["cfg"])
            for dtype in (torch.float32, torch.bfloat16):
                mm[dtype], mm[f"{dtype}_s"] = mmdit_forward(plain, dtype)
            del plain
            torch.cuda.empty_cache()
        return mm["cfg"]

    def mmdit_check(name, what, y, dtype, secs, want, fp32_tol):
        """Rank 0 holds y to the plain forward (fp32: allclose at fp32_tol;
        bf16: relative error within twice the plain bf16 forward's own
        against fp32); every rank holds y to rank 0's, bit for bit."""
        same = same_as_rank0(y)
        ok, check = same, f"equal to rank 0's bit for bit: {same}"
        if rank == 0:
            ref, ref32 = mm[dtype], mm[torch.float32]
            err = rel(y, ref)
            if dtype == torch.float32:
                close = torch.allclose(y, ref, **fp32_tol)
                check = (f"max_abs={(y - ref).abs().max().item():.3e} rel={err:.3e} (allclose "
                         f"atol {fp32_tol['atol']:.0e} rtol {fp32_tol['rtol']:.0e}: {close})")
            else:
                floor = rel(ref, ref32)
                close = err <= 2 * floor
                check = (f"rel={err:.3e} (tol 2x the plain bf16 forward's rel against fp32, "
                         f"2 x {floor:.3e})")
            ok = ok and close
            check += f"; {secs:.3f} s, the plain forward {mm[f'{dtype}_s']:.3f} s"
        part(name, what, secs, want, ok, check)

    def gen_part():
        """[parallel-gen]: an SD1.5 512x512 euler_ancestral bf16 image at batch
        2 on (data 2, model 1), each rank sampling its row with its rows of
        the global noise, against the one-device bf16 and fp32 calls."""
        from tinyfusers_tpu_torch.pipeline import samplers

        t_group = time.perf_counter()
        mesh = parallel.make_mesh(data=2, model=1)
        ids, uncond = (x.expand(2, -1).contiguous() for x in sd15_prompt(dev))
        latent = sd.initial_latent(6, 2, sd.SD15, device=dev)
        real, drawn = samplers._normal, []

        def recorded(generator, like):  # every noise draw of the sampler, as drawn
            x = real(generator, like)
            drawn.append(x.clone())
            return x

        def image(model, dtype, on=None):
            return sd.generate(model, ids, uncond, latent.to(dtype), GUIDANCE,
                               num_steps=GEN_STEPS, method="euler_ancestral",
                               generator=torch.Generator(device=dev).manual_seed(7), mesh=on)

        samplers._normal = recorded
        try:
            model = sd.StableDiffusion(sd.SD15, device=dev, seed=51)
            refs = {}
            if rank == 0:  # the one-device calls: fp32, then bf16 with its draws kept
                for dt in (torch.float32, torch.bfloat16):
                    drawn.clear()
                    t0 = time.perf_counter()
                    refs[dt] = image(model.to(dt), dt)
                    refs[f"{dt}_s"] = seconds_since(t0)
            model.to(torch.bfloat16)
            n = torch.tensor([len(drawn)], device=dev)
            dist.broadcast(n, src=0)
            # (clones made here: the draws are inference tensors, which the
            # broadcast may not write to)
            dense = ([x.clone() for x in drawn] if rank == 0 else
                     [torch.empty((2, 64, 64, 4), device=dev) for _ in range(int(n))])
            for x in dense:
                dist.broadcast(x, src=0)
            parallel.shard_params(model, mesh)
            drawn.clear()
            t0 = start()
            img = image(model, torch.bfloat16, mesh)
            secs = seconds_since(t0)
        finally:
            samplers._normal = real
        r = mesh.get_local_rank("data")
        rows = (len(drawn) == len(dense)
                and all(torch.equal(a, b[r:r + 1]) for a, b in zip(drawn, dense)))
        same = same_as_rank0(img)
        ok = rows and same and img.shape == (2, 512, 512, 3)
        check = (f"{len(drawn)} noise draws, each this rank's row of the one-device draw bit "
                 f"for bit: {rows}; image equal to rank 0's bit for bit: {same}")
        if rank == 0:
            err = (img.float() - refs[torch.float32].float()).abs().mean().item()
            floor = (refs[torch.bfloat16].float() - refs[torch.float32].float()).abs().mean().item()
            ok = ok and err <= 2 * floor
            check += (f"; mean |d pixel| against the one-device fp32 call {err:.4f} (tol 2x the "
                      f"one-device bf16 call's, 2 x {floor:.4f}); {secs:.2f} s, one device "
                      f"bf16 {refs[f'{torch.bfloat16}_s']:.2f} s, fp32 "
                      f"{refs[f'{torch.float32}_s']:.2f} s")
        flash, geglu = unet_launches(cfg, 64, 2)  # a rank's row, CFG: the batch-2 pass
        part("gen_ancestral", f"SD1.5 512x512 {GEN_STEPS}-step euler_ancestral CFG {GUIDANCE} "
             "bf16 batch 2 through generate(mesh=, generator=) on (data 2, model 1) against "
             "the one-device calls", secs,
             {"flash_packed": GEN_STEPS * sum(flash.values()), "flash_bhsd": 1,
              "geglu": GEN_STEPS * sum(geglu.values())}, ok, check)
        del model, img, refs, dense
        torch.cuda.empty_cache()
        wall("gen", t_group)

    def cn_part():
        """[parallel-cn]: an SD1.5 512x512 fp32 ControlNet image at model 2
        (the UNet and the ControlNet split by shard_params) against the
        unsharded image."""
        from tinyfusers_tpu_torch.models import controlnet as cn_mod

        t_group = time.perf_counter()
        mesh = parallel.make_mesh(data=1, model=2)
        ids, uncond = sd15_prompt(dev)
        latent = sd.initial_latent(8, 1, sd.SD15, device=dev)
        hint = torch.rand((1, 512, 512, 3), generator=torch.Generator(device=dev).manual_seed(9),
                          device=dev)

        def models():
            cn = cn_mod.ControlNet(cfg, device=dev, seed=62)
            fill_zero_init(cn, 63)  # the JAX init's zero convs would add nothing
            return sd.StableDiffusion(sd.SD15, device=dev, seed=61), cn

        def image(model, cn, on=None):
            return sd.generate(model, ids, uncond, latent, GUIDANCE, num_steps=CN_STEPS,
                               control=(cn, hint, 0.9), mesh=on)

        want_img = None
        if rank == 0:
            model, cn = models()
            t0 = time.perf_counter()
            want_img = image(model, cn)
            dense_s = seconds_since(t0)
            del model, cn
            torch.cuda.empty_cache()
        model, cn = models()
        parallel.shard_params(model, mesh)
        parallel.shard_params(cn, mesh)
        split = sum(1 for m in cn.modules() if getattr(m, "tp_role", None))
        t0 = start()
        img = image(model, cn, mesh)
        secs = seconds_since(t0)
        flash, geglu = launches_of((1, tp_shapes(unet_launches(cfg, 64, 2), 2)),
                                   (1, tp_shapes(unet_launches(cfg, 64, 2, "control"), 2)))
        want = {"flash_packed": CN_STEPS * sum(flash.values()), "flash_bhsd": 1,
                "geglu": CN_STEPS * sum(geglu.values())}
        same = same_as_rank0(img)
        ok, check = same and split > 0, (f"{split} ControlNet Linears split; equal to rank 0's "
                                         f"bit for bit: {same}")
        if rank == 0:
            diff = (img.int() - want_img.int()).abs()
            ok = ok and diff.max().item() <= 1
            check += (f"; max |d pixel| {diff.max().item()} against the unsharded image (tol 1 "
                      f"of 255), {(diff > 0).float().mean().item():.4%} of pixels differ; "
                      f"{secs:.2f} s, unsharded {dense_s:.2f} s")
        part("cn_image", f"SD1.5 + ControlNet 512x512 {CN_STEPS}-step DDIM CFG {GUIDANCE} fp32 "
             "image through generate(mesh=, control=) at model 2 (the ControlNet split as the "
             "UNet) against the unsharded image", secs, want, ok, check)
        del model, cn, img
        torch.cuda.empty_cache()
        wall("cn", t_group)

    def ring_parts():
        t_group = time.perf_counter()
        mesh = parallel.make_mesh(data=1, model=2)
        # the SD1.5 image, fp32: the ring's exact-math blocks against the
        # kernels' within 1 of 255 need fp32 (bf16 rounds the two otherwise)
        rcfg = dataclasses.replace(sd.SD15, unet=dataclasses.replace(
            sd.SD15.unet, self_attn_impl="ring:model"))
        ids, uncond = sd15_prompt(dev)
        latent = sd.initial_latent(4, 1, sd.SD15, device=dev)
        want_img, dense_s = None, None
        if rank == 0:
            dense = sd.StableDiffusion(sd.SD15, device=dev, seed=21)
            t0 = time.perf_counter()
            want_img = sd.generate(dense, ids, uncond, latent, GUIDANCE, num_steps=RING_STEPS)
            dense_s = seconds_since(t0)
            del dense
            torch.cuda.empty_cache()
        model = parallel.shard_params(sd.StableDiffusion(rcfg, device=dev, seed=21), mesh)
        t0 = start()
        img = sd.generate(model, ids, uncond, latent, GUIDANCE, num_steps=RING_STEPS, mesh=mesh)
        secs = seconds_since(t0)
        flash, geglu = tp_shapes(unet_launches(cfg, 64, 2), 2)  # the ring takes every attn1
        want = {"flash_packed": RING_STEPS * sum(n for k, n in flash.items() if k[2] == 77),
                "flash_bhsd": 1, "geglu": RING_STEPS * sum(geglu.values())}
        same = same_as_rank0(img)
        ok, check = same, f"equal to rank 0's bit for bit: {same}"
        if rank == 0:
            diff = (img.int() - want_img.int()).abs()
            ok = ok and diff.max().item() <= 1
            check = (f"max |d pixel| {diff.max().item()} against the unsharded image (tol 1 of "
                     f"255), {(diff > 0).float().mean().item():.4%} of pixels differ; "
                     f"{secs:.2f} s, unsharded {dense_s:.2f} s")
        part("ring_image", f"SD1.5 512x512 {RING_STEPS}-step DDIM CFG {GUIDANCE} fp32 image "
             "through generate(mesh=) with self_attn_impl=\"ring:model\" on (data 1, model "
             "2) against the unsharded image", secs, want, ok, check)
        del model, img
        torch.cuda.empty_cache()
        # the MMDiT with its joint attention on the ring over the model axis
        mcfg = mmdit_refs()
        model = parallel.shard_params(mmdit(dataclasses.replace(mcfg, attn_impl="ring:model")),
                                      mesh)
        none = dict.fromkeys(counted, 0)
        for dtype in (torch.float32, torch.bfloat16):
            y, secs = mmdit_forward(model, dtype, mesh)
            mmdit_check(f"ring_mmdit_{str(dtype)[6:]}", "SD3-medium MMDiT (2,128,128,16), 77 "
                        f"text tokens, {str(dtype)[6:]}, attn_impl=\"ring:model\" on (data 1, "
                        "model 2) against the plain forward", y, dtype, secs, none,
                        dict(atol=2e-4, rtol=2e-3))
        del model
        torch.cuda.empty_cache()
        wall("ring", t_group)

    def pipe_parts():
        t_group = time.perf_counter()
        mcfg = mmdit_refs()
        mesh = parallel.make_mesh(data=1, pipe=2)
        model = mmdit(dataclasses.replace(mcfg, pipeline_microbatches=2))
        # the pipe's placement: this stage's half of the blocks kept, the rest freed
        whole = sum(p.numel() for p in model.blocks.parameters())
        parallel.shard_params(model, mesh)
        torch.cuda.empty_cache()
        stage, per = mesh.get_local_rank("pipe"), mcfg.depth // 2
        kept = [i for i, b in enumerate(model.blocks)
                if not isinstance(b, parallel.pipeline.Elsewhere)]
        held = sum(p.numel() for p in model.blocks.parameters())
        placed = kept == list(range(stage * per, (stage + 1) * per)) and 2 * held == whole
        placement = (f"stage {stage} holds blocks {kept[0]}-{kept[-1]} of {mcfg.depth}, "
                     f"{held} of the {whole} block parameters ({held / whole:.3f}; tol 1/2), "
                     f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated by this rank "
                     "in fp32")
        want = {"flash_packed": mcfg.depth, "flash_bhsd": 0, "geglu": 0}  # half the blocks, twice
        for dtype in (torch.float32, torch.bfloat16):
            y, secs = mmdit_forward(model, dtype, mesh)
            name = f"pipe_{str(dtype)[6:]}"
            mmdit_check(name, "SD3-medium MMDiT (2,128,128,16), 77 text "
                        f"tokens, {str(dtype)[6:]}, pipeline_microbatches=2 over a two-stage "
                        "pipe against the plain forward", y, dtype, secs, want,
                        dict(atol=1e-5, rtol=1e-5))
            out[name]["ok"] = out[name]["ok"] and placed
            out[name]["check"] += f"; {placement}"
        del model
        mm.clear()
        torch.cuda.empty_cache()
        wall("pipe", t_group)

    def serve_parts():
        import numpy as np

        from tinyfusers_tpu_torch.serve import Engine, Router

        t_group = time.perf_counter()
        ids, uids = np.full((77,), 3, np.int64), np.zeros((77,), np.int64)

        def run(eng):
            for i, n in enumerate(SERVE_MESH_STEPS):
                eng.submit(eng.make_request(ids, uids, num_steps=n, guidance=5.0, seed=i))
            return {r.request_id: r.image for r in eng.run_until_idle()}

        def on_card(images):
            return {k: torch.from_numpy(v).to(dev) for k, v in sorted(images.items())}

        def model_of(dt):  # the same seeded weights, served in dt
            return sd.StableDiffusion(sd.SD15, device=dev, seed=41).to(dt)

        def level_err(images, ref):  # mean |d pixel| over all images
            return torch.cat([(images[k].float() - ref[k].float()).abs().flatten()
                              for k in sorted(ref)]).mean().item()

        def off(images, ref):  # (max |d pixel|, the largest share of an image's pixels off)
            diffs = [(images[k].int() - ref[k].int()).abs() for k in sorted(ref)]
            return (max(d.max().item() for d in diffs),
                    max((d > 0).float().mean().item() for d in diffs))

        # the one-device engine's images in fp32 and bf16 (served as in phase
        # 5e), on every rank; on rank 0 the bf16 witness: the one-device
        # engine at SERVE_SLOTS / 2 slots, the rows a rank of the data axis runs
        models = {torch.float32: model_of(torch.float32), torch.bfloat16: model_of(torch.bfloat16)}
        refs, ref_s, witness = {}, {}, None
        for dt, m in models.items():
            ref = {i: torch.empty((512, 512, 3), dtype=torch.uint8, device=dev)
                   for i in range(len(SERVE_MESH_STEPS))}
            if rank == 0:
                t0 = time.perf_counter()
                ref = on_card(run(Engine(m, num_slots=SERVE_SLOTS)))
                ref_s[dt] = seconds_since(t0)
                if dt == torch.bfloat16:
                    witness = on_card(run(Engine(m, num_slots=SERVE_SLOTS // 2)))
            for img in ref.values():
                dist.broadcast(img, src=0)
            refs[dt] = ref
        floor16 = level_err(refs[torch.bfloat16], refs[torch.float32])
        engines = {}
        for dt in (torch.float32, torch.bfloat16):
            sfx = "" if dt == torch.float32 else "_bf16"
            for data, model_n in ((2, 1), (1, 2)):
                name = f"serve_{'data2' if data == 2 else 'model2'}{sfx}"
                mesh = parallel.make_mesh(data=data, model=model_n)
                model = models[dt] if data == 2 else model_of(dt)
                eng = Engine(parallel.shard_params(model, mesh), num_slots=SERVE_SLOTS, mesh=mesh)
                t0 = start()
                got = run(eng)
                secs = seconds_since(t0)
                want = engine_launches(cfg, SERVE_MESH_STEPS, SERVE_SLOTS,
                                       (data, mesh.get_local_rank("data")), model_n)
                launched = {kn: w.launches for kn, w in counted.items()}
                got = on_card(got)
                ok = got.keys() == refs[dt].keys()
                same = ok and all([same_as_rank0(got[k]) for k in sorted(got)])
                worst, frac = off(got, refs[dt]) if ok else (-1, -1.0)
                check = (f"{len(got)} images; equal to rank 0's bit for bit: {same}; against the "
                         f"one-device {str(dt)[6:]} engine's: max |d pixel| {worst}, at most "
                         f"{frac:.4%} of an image's pixels differ")
                if dt == torch.float32:
                    ok = ok and same and worst <= 1 and frac < 0.02
                    check += " (tol 1 level on < 2%)"
                else:
                    # bf16: another batch of rows (data 2) or split of the sums (model 2)
                    # rounds otherwise; held to twice the one-device bf16 engine's own
                    # error against fp32
                    err = level_err(got, refs[torch.float32]) if ok else -1.0
                    ok = ok and same and err <= 2 * floor16
                    check += (f"; mean |d pixel| against the one-device fp32 engine's {err:.4f} "
                              f"(tol 2x the one-device bf16 engine's, 2 x {floor16:.4f})")
                    if witness is not None:
                        w_worst, w_frac = off(witness, refs[dt])
                        check += (f"; witness: the one-device bf16 engine at {SERVE_SLOTS // 2} "
                                  f"slots against {SERVE_SLOTS}: max |d pixel| {w_worst}, at "
                                  f"most {w_frac:.4%} of pixels differ; this engine equal to "
                                  f"the {SERVE_SLOTS // 2}-slot one bit for bit: "
                                  f"{off(got, witness) == (0, 0.0)}")
                check += f"; {secs:.2f} s" + (f", the one-device engine {ref_s[dt]:.2f} s"
                                              if dt in ref_s else "")
                if launched != {kn: w.launches for kn, w in counted.items()}:
                    ok, check = False, f"launches after the run: {launched}, then more"
                part(name, f"the {str(dt)[6:]} SD1.5 Engine, {SERVE_SLOTS} slots on (data "
                     f"{data}, model {model_n}), requests of {list(SERVE_MESH_STEPS)} steps, "
                     "against the one-device engine", secs, want, ok, check)
                engines[name] = eng
        dense = models[torch.float32]
        # a Router over the (data 2, model 1) engine and a local one-slot engine
        big = engines["serve_data2"]
        big.reset()
        router = Router({"big": big, "small": Engine(dense, num_slots=1)})
        t0 = start()
        rids = [router.submit("big" if i % 2 == 0 else "small", ids, uids, num_steps=2,
                              seed=10 + i) for i in range(3)]
        done = on_card({r.request_id: r.image for r in router.run_until_idle()})
        secs = seconds_since(t0)
        health = router.health()
        same = all([same_as_rank0(img) for img in done.values()])
        ok = (sorted(done) == sorted(rids) and same
              and all(h["failures"] == 0 for h in health.values()))
        big_w = engine_launches(cfg, (2, 2), SERVE_SLOTS, (2, big.mesh.get_local_rank("data")), 1)
        small_w = engine_launches(cfg, (2,), 1, (1, 0), 1)
        part("serve_router", "a Router over the (data 2, model 1) engine and a local one-slot "
             "engine, 3 requests of 2 steps", secs,
             {kn: big_w[kn] + small_w[kn] for kn in big_w}, ok,
             f"{len(done)} of {len(rids)} requests done, health {health}; images equal to "
             f"rank 0's bit for bit: {same}; {secs:.2f} s")
        del engines, big, router, dense, models, refs, witness
        torch.cuda.empty_cache()
        wall("serve", t_group)

    def tp2_parts():
        forward_parts()
        train_part("train_tp", "one train step fp32, data 1 x model 2 (tensor parallel), batch "
                   "2, remat, SGD after clipping, against the unsharded step", mesh,
                   optim.chain(optim.clip_by_global_norm(1.0), optim.sgd(TP2_LR)), False)
        train_part("train_fsdp", "one train step fp32, data 2 x model 1 (FSDP: params and "
                   "momentum split over the data ranks), one row a rank, remat, SGD with "
                   "momentum after clipping, against the unsharded step on both rows",
                   parallel.make_mesh(data=2, model=1),
                   optim.chain(optim.clip_by_global_norm(1.0),
                               optim.sgd(TP2_LR, momentum=0.9)), True)

    def adafactor_parts():
        def adafactor(model):  # optax.adafactor's defaults, each leaf factored in the JAX layout
            return optim.adafactor(ADA_LR, layouts=train.param_layouts(model))

        t_group = time.perf_counter()
        train_part("ada_tp", "one Adafactor train step fp32, data 1 x model 2 (tensor "
                   "parallel: each statistic reduced over the model group), batch 2, remat, "
                   "against the unsharded step", mesh, adafactor, False, ADA_UPDATE_TOL)
        train_part("ada_fsdp", "one Adafactor train step fp32, data 2 x model 1 (FSDP: params "
                   "split over the data ranks, statistics reduced over them), one row a rank, "
                   "remat, against the unsharded step on both rows",
                   parallel.make_mesh(data=2, model=1), adafactor, True, ADA_UPDATE_TOL)
        wall("adafactor", t_group)

    mesh = parallel.make_mesh(data=1, model=2)

    x0 = torch.randn((2, 64, 64, 4), generator=g, device=dev)
    c0 = torch.randn((2, 77, 768), generator=g, device=dev)

    def forward_parts():  # the forward at model = 2, fp32 and bf16, against the unsharded UNet
        x16, ctx16 = x.bfloat16(), ctx.bfloat16()
        with torch.inference_mode():
            model = unet()
            want32, dense32 = timed(lambda: unet_mod.apply(model, x, t, ctx))
            m16 = unet(torch.bfloat16)
            want16, dense16 = timed(lambda: unet_mod.apply(m16, x16, t, ctx16))
            parallel.shard_params(model, mesh)
            parallel.shard_params(m16, mesh)
            got32, secs = timed(lambda: unet_mod.apply(model, x, t, ctx))
            ok = torch.allclose(got32, want32, atol=2e-4, rtol=2e-3)
            part("forward_fp32", "SD1.5 UNet fp32 (2,64,64,4) at model = 2 against the unsharded "
                 "UNet on the card", secs, per_forward, ok,
                 f"max_abs={(got32 - want32).abs().max().item():.3e} rel={rel(got32, want32):.3e} "
                 f"(allclose atol 2e-4 rtol 2e-3: {ok}); a warm forward {secs:.4f} s sharded, "
                 f"{dense32:.4f} s unsharded")
            got16, secs = timed(lambda: unet_mod.apply(m16, x16, t, ctx16))
            err16, floor16 = rel(got16, want16), rel(want16, want32)
            # two bf16 evaluations, each about floor16 from the fp32 result, lie
            # up to about sqrt(2) floor16 apart: the limit is 2 floor16
            part("forward_bf16", "SD1.5 UNet bf16 (2,64,64,4) at model = 2 against the unsharded "
                 "bf16 UNet on the card", secs, per_forward, err16 <= 2 * floor16,
                 f"rel={err16:.3e} (tol 2x the unsharded bf16 UNet's rel against fp32, "
                 f"2 x {floor16:.3e}; sharded bf16 against fp32 rel={rel(got16, want32):.3e}); a "
                 f"warm forward {secs:.4f} s sharded, {dense16:.4f} s unsharded")
        del model, m16, want32, want16, got32, got16
        torch.cuda.empty_cache()

    def leaves_close(got, want):
        bad = [k for k in want if not torch.allclose(got[k], want[k], rtol=2e-3, atol=2e-5)]
        worst = max(((got[k] - want[k]).abs().max().item() for k in want), default=0.0)
        return not bad, (f"{len(want) - len(bad)}/{len(want)} leaves within rtol 2e-3 atol "
                         f"2e-5 (max |d| {worst:.3e}{', first off: ' + bad[0] if bad else ''})")

    def replicas_close(state, m):
        """This rank's copies of the leaves whole over the mesh, and its loss
        and grad_norm, against rank 0's (broadcast): a replica that drifts
        from rank to rank fails here."""
        bad, worst, n = [], 0.0, 0
        for k, v in state.params.items():  # one leaf at a time: the same order on each rank
            if state.placements[k].sharded:
                continue
            ref = v.clone()
            dist.broadcast(ref, src=0)
            n += 1
            worst = max(worst, (v - ref).abs().max().item())
            if not torch.allclose(v, ref, rtol=2e-3, atol=2e-5):
                bad.append(k)
        mets = torch.tensor([float(m["loss"]), float(m["grad_norm"])], dtype=torch.float64,
                            device=dev)
        ref = mets.clone()
        dist.broadcast(ref, src=0)
        same = torch.allclose(mets, ref, rtol=2e-4, atol=0.0)
        return not bad and same, (
            f"{n - len(bad)}/{n} replicated leaves within rtol 2e-3 atol 2e-5 of rank 0's "
            f"(max |d| {worst:.3e}{', first off: ' + bad[0] if bad else ''}); loss and "
            f"grad_norm {mets.tolist()} against rank 0's {ref.tolist()} within rtol 2e-4: {same}")

    def updates_close(new, old, want_new, want_old, tol):
        """Each leaf's update (new - old, exact in fp64) against the
        unsharded step's: the norm of the difference over the norm of the
        unsharded update, at most ``tol`` on every leaf."""
        worst, worst_k = 0.0, None
        for k in want_new:
            ref = want_new[k].double() - want_old[k].double()
            d = (new[k].double() - old[k].double() - ref).norm().item()
            ref_n = ref.norm().item()
            r = 0.0 if d == 0 else d / ref_n if ref_n else math.inf
            if r >= worst:
                worst, worst_k = r, k
        return worst <= tol, (f"each leaf's update against the unsharded update: worst "
                              f"|d| / |update| {worst:.3e} ({worst_k}; tol {tol:.0e})")

    def train_part(name, what, mesh, tx, fsdp, update_tol=None):
        """One step on each side, timed. tx: the optimizer, or a function of
        the model giving it. update_tol: also hold each leaf's update to the
        unsharded one's (``updates_close``)."""
        tx_of = tx if callable(tx) else (lambda model: tx)

        def state_of(model, placements=None):
            return train.TrainState.create(train.params_of(model, trainable_only=True),
                                           tx_of(model), placements=placements)

        want = None
        if rank == 0:  # the unsharded step on the global batch, then a second one timed
            dense = set_trainable(unet())
            step = train.make_train_step(train.module_apply(dense), tx_of(dense), remat=True)
            old = state_of(dense)
            t0 = time.perf_counter()
            new, m = step(old, (x0, c0), torch.Generator(device=dev).manual_seed(13))
            dense_s = seconds_since(t0)
            want = (new.params, float(m["loss"]), float(m["grad_norm"]), old.params)
            del new, old
            del dense, step
            torch.cuda.empty_cache()
        model = set_trainable(parallel.shard_params(unet(), mesh))
        state = state_of(model, parallel.sharding_tree(model, mesh))
        if fsdp:
            state = parallel.shard_fsdp(state, mesh)
        old_whole = parallel.unshard(state.params, state.placements) if update_tol else None
        held = sum(v.numel() for v in state.params.values())
        step = train.make_train_step(train.module_apply(model), tx_of(model), remat=True)
        batch = train.shard_batch((x0, c0), mesh)
        t0 = start()
        new, m = step(state, batch, torch.Generator(device=dev).manual_seed(13))
        first_s = seconds_since(t0)
        launched = {kn: w.launches for kn, w in counted.items()}
        whole = parallel.unshard(new.params, new.placements)
        ok, check = replicas_close(new, m)
        if want is not None:
            close, check = leaves_close(whole, want[0])
            if update_tol:
                moved, how = updates_close(whole, old_whole, want[0], want[3], update_tol)
                close, check = close and moved, f"{check}; {how}"
            loss, norm = float(m["loss"]), float(m["grad_norm"])
            ok = (ok and close and abs(loss - want[1]) <= 2e-4 * abs(want[1])
                  and abs(norm - want[2]) <= 2e-4 * abs(want[2]))
            check = (f"loss {loss:.6f} (unsharded {want[1]:.6f}), grad_norm {norm:.4f} "
                     f"(unsharded {want[2]:.4f}), within rtol 2e-4; params: {check}; this "
                     f"rank holds {held / sum(v.numel() for v in want[0].values()):.3f} of "
                     f"the state's params")
        if launched != {kn: w.launches for kn, w in counted.items()}:
            ok, check = False, f"launches after the step: {launched}, then more"
        del new, whole, old_whole
        if want is not None:
            check += f"; the first step {first_s:.3f} s sharded, {dense_s:.3f} s unsharded"
        part(name, what, first_s, {kn: 2 * n for kn, n in per_forward.items()}, ok, check)
        del model, state, want
        torch.cuda.empty_cache()

    for run in (tp2_parts, adafactor_parts, gen_part, cn_part, ring_parts, pipe_parts,
                serve_parts):
        run()
    Path(outdir, f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA GPU: this smoke run needs one")
    if not (ROOT / "tinyfusers_tpu_torch").is_dir():
        fail("tinyfusers_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import torch.nn.functional as F

    from tinyfusers_tpu_torch.kernels import _build
    from tinyfusers_tpu_torch.kernels.flash_attention import (
        _plan, flash_bhsd, flash_bhsd_diff, flash_bhsd_plain, flash_packed, flash_packed_diff,
        flash_packed_plain)
    from tinyfusers_tpu_torch.io import checkpoints
    from tinyfusers_tpu_torch.io.quantize_tree import quantize_params
    from tinyfusers_tpu_torch.kernels.geglu_ff import _plan as geglu_plan
    from tinyfusers_tpu_torch.kernels.geglu_ff import (
        erf_as, geglu_matmul, geglu_matmul_diff, geglu_matmul_plain)
    from tinyfusers_tpu_torch.kernels.quant_matmul import _plan as quant_plan
    from tinyfusers_tpu_torch.kernels.quant_matmul import (
        quant_matmul, quant_matmul_int4, quant_matmul_int4_plain, quant_matmul_plain)
    from tinyfusers_tpu_torch.io import safetensors_io, state_map
    from tinyfusers_tpu_torch.models import dit as dit_mod
    from tinyfusers_tpu_torch.models import mmdit as mmdit_mod
    from tinyfusers_tpu_torch.models import t5 as t5_mod
    from tinyfusers_tpu_torch.models import unet as unet_mod
    from tinyfusers_tpu_torch.models import vae as vae_mod
    from tinyfusers_tpu_torch.models import controlnet as cn_mod
    from tinyfusers_tpu_torch.models.layers import Linear, ZeroConv, ZeroLinear, init_weights
    from tinyfusers_tpu_torch import ops
    from tinyfusers_tpu_torch.ops import gelu_erf
    from tinyfusers_tpu_torch.ops.quant import Int4Tensor, is_quantized, quantize, quantize_int4
    from tinyfusers_tpu_torch.pipeline import sd, sd3, sdxl

    wrappers = {"flash_packed": flash_packed, "flash_bhsd": flash_bhsd,
                "geglu": geglu_matmul, "quant_matmul": quant_matmul,
                "quant_matmul_int4": quant_matmul_int4}
    # entries of the kernels line that are not a wrapper's own name: the
    # SD3 calls of flash_packed stand for the TPU's multi-k kernel
    wrapper_of = {"flash_packed_multik": "flash_packed"}
    # quantized formats: the quantize_params argument, the wrapper, the
    # plain version and the phase-3 row key of a call (M, K, N)
    qformats = {
        "int8": (torch.int8, "quant_matmul", quant_matmul_plain,
                 lambda m, k, n: ("int8", m, k, n)),
        "fp8": (torch.float8_e4m3fn, "quant_matmul", quant_matmul_plain,
                lambda m, k, n: ("fp8", m, k, n)),
        "int4": ("int4", "quant_matmul_int4", quant_matmul_int4_plain,
                 lambda m, k, n: (m, k, n, 64)),
    }

    def stamp(phases: str) -> None:  # where the run's seconds go
        say(f"[time] {phases} done {time.perf_counter() - t_start:.1f} s after the start")

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
            w.shapes.clear()
            if hasattr(w, "variants"):
                w.variants.clear()

    def variants():  # flash and geglu wrapper -> launches by kernel variant
        return {"flash_packed": dict(flash_packed.variants),
                "flash_bhsd": dict(flash_bhsd.variants),
                "geglu": dict(geglu_matmul.variants)}

    # 1. device ----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = smi()
    say(f"[device] {name} count={count} torch={torch.__version__} "
        f"cuda={torch.version.cuda} nvidia-smi: {card}; TF32 off for matmul "
        f"and cuDNN, so fp32 comparisons are exact fp32")
    dev = torch.device("cuda:0")

    # 2. build -----------------------------------------------------------
    build_s = _build.build_all()
    say(f"[build] kernels from tinyfusers_tpu_torch/csrc built in {build_s:.2f} s")
    for stem, log in sorted(_build.build_log.items()):
        kernel = "?"
        for line in log.splitlines():
            if "Function properties for" in line:
                kernel = short_kernel_name(line.split()[-1])
            elif "Used" in line or "spill" in line.lower():
                say(f"[build] {stem}: {kernel}: {line.split(':', 1)[-1].strip()}")

    stamp("1-2 (device, build)")

    # 3. each kernel against its plain version ---------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    # the quantized UNets' linears from their build_plan: SD1.5's must be the
    # 19 listed shapes; SDXL-base's at 1024x1024, CFG batch 2, 20 steps
    sd15_quant = {k: STEPS * n for k, n in unet_quant_launches(sd.SD15.unet, 64, 2).items()}
    if sd15_quant != QUANT_SHAPES:
        fail(f"SD1.5 quantized linears from build_plan {sd15_quant} are not QUANT_SHAPES")
    sdxl_quant = {k: STEPS * n
                  for k, n in unet_quant_launches(sdxl.SDXL_BASE.unet, 128, 2).items()}
    # ... and the serving engine's: one slot step runs SD1.5's UNet at the 2S
    # rows of S = 4 slots, M = 4x the batch-2 rows (launches per tick)
    serve_quant = unet_quant_launches(sd.SD15.unet, 64, 2 * SERVE_SLOTS)
    quant_bf16 = list(dict.fromkeys([*QUANT_SHAPES, *sdxl_quant, *MMDIT_QUANT_SHAPES,
                                     *serve_quant]))

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # Tolerances on ||kernel - plain|| / ||plain||. fp32: both sides are
    # exact fp32 and differ only in summation order. bf16 attention: the
    # kernel rounds P to bf16 against a running (per 64-key tile) max, the
    # plain version against the row's global max, so P's roundings differ.
    # bf16 GEGLU: h is the plain version's bit for bit, so only the fp32
    # sums' order differs, then one bf16 rounding; the limit sits below the
    # error of h left unrounded before the product (``planted_rel``), which
    # the run measures and holds above it.
    # bf16 quant matmuls: the weight converts to bf16 identically on both
    # sides, so only the sums' order differs; the limit sits below the
    # error of either rounding hazard of the formats (``planted``), which
    # the run measures and holds above it.
    tol = {("attn", torch.bfloat16): 1e-2, ("attn", torch.float32): 1e-5,
           ("geglu", torch.bfloat16): 5e-4, ("geglu", torch.float32): 1e-5,
           ("quant", torch.bfloat16): 5e-4, ("quant", torch.float32): 1e-5}
    # Per-row limits (the worst row's relative error), so that a fault in a
    # few rows of a large output shows. Measured on an H100 at these shapes:
    # bf16 attention rows at most 3.6e-3, fp32 1.8e-6; bf16 quant rows at
    # most 1.2e-3 (int4, K = 1280 over N = 320), int8 / fp8 8.7e-4; bf16
    # geglu rows at most 1.02e-3 (K = 2560 over N = 640), fp32 8.6e-7.
    row_tol = {("attn", torch.bfloat16): 1e-2, ("attn", torch.float32): 1e-5,
               ("geglu", torch.bfloat16): 3e-3, ("geglu", torch.float32): 1e-5,
               ("quant", torch.bfloat16): 3e-3, ("quant", torch.float32): 1e-5}
    # A library call counts as computing the same function within this
    # (its scales are in x's dtype, which moves each weight by up to 2^-8).
    lib_tol = 1e-2
    report = {kname: {} for kname in [*wrappers, *wrapper_of]}  # entry -> shape -> bf16 row

    def measured(wname):
        """The call shapes of wrapper ``wname`` that phase 3 measured."""
        return {key for entry, rows in report.items()
                if wrapper_of.get(entry, entry) == wname for key in rows}

    def reps(flops):  # calls per CUDA-graph replay: fewer for the largest
        return 10 if flops < 1e11 else 3

    def record(kname, label, key, dt, err, t_k, t_p, t_lib, flops, nbytes, limit,
               row_limit=None, **extra):
        b_ms, b_by = bound(flops, nbytes, dt)
        lib = "n/a" if t_lib is None else f"{t_lib:.4f}"
        more = "".join(f" {k}={v:.4g}" if isinstance(v, float) else f" {k}={v}"
                       for k, v in extra.items() if v is not None)
        row = "" if row_limit is None else f" row={err[2]:.3e} (tol {row_limit:.0e})"
        say(f"[kernel] {kname} {label} {str(dt)[6:]}: max_abs={err[0]:.3e} "
            f"rel={err[1]:.3e} (tol {limit:.0e}){row} kernel_ms={t_k:.4f} "
            f"plain_ms={t_p:.4f} library_ms={lib}{more} bound_ms={b_ms:.4f} ({b_by})")
        if not err[1] <= limit:
            fail(f"{kname} {label} {dt}: rel err {err[1]:.3e} > {limit:.0e}")
        if row_limit is not None and not err[2] <= row_limit:
            fail(f"{kname} {label} {dt}: a row's rel err {err[2]:.3e} > {row_limit:.0e}")
        if dt == torch.bfloat16:
            report[kname][key] = dict(
                shape=label, call=list(key), max_abs_err=err[0], rel_err=err[1],
                row_rel_err=err[2], ms=t_k, plain_ms=t_p, library_ms=t_lib, bound_ms=b_ms,
                bound_by=b_by, **extra)

    def int8pack_mm(x, leaf):
        """torch._weight_int8pack_mm on the same int8 weight (no bias, its
        scales in x's dtype), where this PyTorch build has it on CUDA."""
        w8, sc = leaf.weight_values, leaf.weight_scales.reshape(-1).to(x.dtype)
        try:
            torch._weight_int8pack_mm(x, w8, sc)
        except (RuntimeError, NotImplementedError, AttributeError) as e:
            return None, f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
        return (lambda: torch._weight_int8pack_mm(x, w8, sc)), None

    def planted(x, w, b, hazard="product"):
        """The plain version with the format's rounding hazard planted:
        int4 with the scaled weight left in fp32 (not rounded to x's dtype
        before the product), or (hazard "scale") with each scale rounded to
        x's dtype before the fp32 product, as a bf16 __hmul2 decode would;
        int8 / fp8 with the scale folded into the weight in x's dtype."""
        if not isinstance(w, Int4Tensor):
            wd = w.dequantize(x.dtype).float()
        elif hazard == "scale":
            wd = Int4Tensor(w.packed, w.scales.to(x.dtype).float(), axis=w.axis,
                            group_size=w.group_size, orig_dim=w.orig_dim).dequantize(x.dtype).float()
        else:
            wd = w.dequantize(torch.float32)
        return (x.float() @ wd + b.float()).to(x.dtype)

    def quant_leaf(k, n, qname):
        """A Linear of the model's kind holding seeded weights, quantized as
        quantize_params does it: its container is what the UNet passes."""
        leaf = Linear(k, n, device=dev, dtype=torch.float32)
        with torch.no_grad():
            leaf.weight.copy_(torch.randn(n, k, generator=gen, device=dev) * k ** -0.5)
            leaf.bias.copy_(torch.randn(n, generator=gen, device=dev))
        dense = leaf.weight.detach().clone()
        if qname == "int4":
            leaf.set_weight(quantize_int4(leaf.w, axis=0, group_size=64))
        else:
            leaf.set_weight(quantize(leaf.w, qformats[qname][0]))
        return leaf, dense

    def ran_on(wname, dt, plan):
        """The variant the one launch since reset_counts() ran on; a bf16
        main-path shape must run on a TMA + wgmma kernel, as _plan says."""
        counted = variants()[wname]
        variant = next(iter(counted)) if len(counted) == 1 else None
        if counted != {plan[0]: 1} or (dt == torch.bfloat16 and variant not in WGMMA):
            fail(f"{wname} {dt}: launches by variant {counted}, want one on {plan[0]}")
        return variant

    lib_notes = {}  # format -> why its library call was not timed
    libraries = {"int8": ("torch._weight_int8pack_mm", int8pack_mm),
                 "int4": ("torch._weight_int4pack_mm", lambda x, leaf: int4pack_mm(x, leaf.w))}

    def packed_plain(q, k, v, h, kvl):
        """flash_packed_plain, over query-row chunks where one call's fp32
        logits would pass PLAIN_LOGITS elements (the hires 128x128 self
        attention's are 4.3 G): each chunk takes all keys, and rows are
        independent, so this is the plain version of the whole call."""
        b, sq, _ = q.shape
        rows = max(1, PLAIN_LOGITS // 2 // (b * h * k.shape[1]))
        if b * h * sq * k.shape[1] <= PLAIN_LOGITS:
            return flash_packed_plain(q, k, v, heads=h, kv_len=kvl)
        return torch.cat([flash_packed_plain(q[:, i:i + rows], k, v, heads=h, kv_len=kvl)
                          for i in range(0, sq, rows)], dim=1)

    def event_ms(fn):
        """Device time of one warm call by events (for the chunked plain
        versions: tens of ms a call, whose temporaries a CUDA graph's
        private pool would keep)."""
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    for dt in (torch.bfloat16, torch.float32):
        isz = torch.tensor([], dtype=dt).element_size()
        # fp32 too: the shapes [serve-mesh]'s fp32 engines run (4 rows a rank
        # on the data axis, the training step's; 8 at model = 2)
        packed_rows = ([("flash_packed", *row)
                        for row in PACKED_SHAPES + SD21_PACKED_SHAPES + DIT_PACKED_SHAPES
                        + TP2_PACKED_SHAPES + TRAIN_PACKED_SHAPES + SERVE_TP2_PACKED_SHAPES]
                       + [("flash_packed_multik", *row) for row in MULTIK_SHAPES])
        if dt == torch.bfloat16:  # the hires fix's, the batch-1 branches', SDXL's, serving's
            packed_rows += [("flash_packed", *row)
                            for row in HIRES_PACKED_SHAPES + B1_PACKED_SHAPES
                            + XL_PACKED_SHAPES + SERVE_PACKED_SHAPES]
        for entry, label, (b, sq, sk, c, h, kvl) in packed_rows:
            q, k, v = randn(b, sq, c, dtype=dt), randn(b, sk, c, dtype=dt), randn(b, sk, c, dtype=dt)
            reset_counts()
            got = flash_packed(q, k, v, heads=h, kv_len=kvl)
            torch.cuda.synchronize()
            variant = ran_on("flash_packed", dt, _plan(dt, c // h))
            chunked = b * h * sq * sk > PLAIN_LOGITS
            err = rel_err(got, packed_plain(q, k, v, h, kvl))
            # the work these inputs need: kvl real keys of sk
            flops = 4.0 * b * sq * kvl * c
            nbytes = (2 * b * sq * c + 2 * b * kvl * c) * isz
            n_rep = reps(flops)
            t_k = cuda_ms(lambda: flash_packed(q, k, v, heads=h, kv_len=kvl), n_rep)
            t_p = (event_ms(lambda: packed_plain(q, k, v, h, kvl)) if chunked else
                   cuda_ms(lambda: flash_packed_plain(q, k, v, heads=h, kv_len=kvl), 3))
            split = lambda x, s: x.view(b, s, h, c // h).transpose(1, 2)  # noqa: E731
            qh, kh, vh = split(q, sq), split(k, sk)[:, :, :kvl], split(v, sk)[:, :, :kvl]
            t_l = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), n_rep)
            record(entry, label, (b, sq, sk, c, h, kvl), dt, err, t_k, t_p, t_l, flops, nbytes,
                   tol[("attn", dt)], row_tol[("attn", dt)], variant=variant,
                   tflops=flops / t_k / 1e9, x_library=t_k / t_l,
                   plain_in_row_chunks=chunked or None)
            if (label, dt) == ("64x64 self", torch.bfloat16):
                host_us = wrapper_host_us(lambda: flash_packed(q, k, v, heads=h, kv_len=kvl))
                say(f"[host] flash_packed wrapper at SD1.5 64x64 self {(b, sq, sk, c, h, kvl)}: "
                    f"{host_us:.2f} us of host time per call (median of 5 runs of 200 "
                    f"eager calls, no synchronize between calls)")
            del q, k, v, qh, kh, vh, got
        for label, (n, sq, sk, d) in BHSD_SHAPES:
            q = randn(1, n, sq, d, dtype=dt)
            k, v = randn(1, n, sk, d, dtype=dt), randn(1, n, sk, d, dtype=dt)
            reset_counts()
            got = flash_bhsd(q, k, v)
            torch.cuda.synchronize()
            variant = ran_on("flash_bhsd", dt, _plan(dt, d))
            err = rel_err(got, flash_bhsd_plain(q, k, v))
            flops = 4.0 * n * sq * sk * d
            nbytes = (2 * n * sq * d + 2 * n * sk * d) * isz
            n_rep = reps(flops)
            t_k = cuda_ms(lambda: flash_bhsd(q, k, v), n_rep)
            t_p = cuda_ms(lambda: flash_bhsd_plain(q, k, v), 3)
            t_l = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), n_rep)
            record("flash_bhsd", label, (n, sq, sk, d), dt, err, t_k, t_p, t_l, flops, nbytes,
                   tol[("attn", dt)], row_tol[("attn", dt)], variant=variant,
                   tflops=flops / t_k / 1e9)
        torch.cuda.empty_cache()
        geglu_rows = (GEGLU_SHAPES + SD21_GEGLU_SHAPES + TP2_GEGLU_SHAPES + TRAIN_GEGLU_SHAPES
                      + SERVE_TP2_GEGLU_SHAPES)
        if dt == torch.bfloat16:
            geglu_rows = geglu_rows + HIRES_GEGLU_SHAPES + B1_GEGLU_SHAPES
        geglu_rows = [row for i, row in enumerate(geglu_rows)  # each shape once
                      if row[1] not in {r[1] for r in geglu_rows[:i]}]
        for label, (m, kd, nd), _ in geglu_rows:
            proj = randn(m, 2 * kd, dtype=dt)
            gx, gate = proj.chunk(2, dim=-1)  # strided halves, as in the UNet
            w = (randn(nd, kd, dtype=torch.float32) * kd ** -0.5).to(dt).t()
            bias = randn(nd, dtype=dt)
            reset_counts()
            got = geglu_matmul(gx, gate, w, bias)
            torch.cuda.synchronize()
            plan = geglu_plan(dt, m, kd, nd, gx.stride(0) % 8 == 0)
            ran = dict(geglu_matmul.variants)
            if ran != {plan[0]: 1} or (dt == torch.bfloat16 and plan[0] != "wgmma"):
                fail(f"geglu ({m},{kd},{nd}) {dt}: launches by variant {ran}, plan {plan}; "
                     f"every main-path bf16 shape must run on wgmma")
            want = geglu_matmul_plain(gx, gate, w, bias)
            err = rel_err(got, want)
            planted_rel = None
            if dt == torch.bfloat16:  # h kept in fp32, not rounded before the product
                g32 = gate.float()
                h32 = gx.float() * (0.5 * g32 * (1.0 + erf_as(g32 * 0.7071067811865476)))
                planted_rel = rel_err((h32 @ w.float() + bias.float()).to(dt), want)[1]
            t_k = cuda_ms(lambda: geglu_matmul(gx, gate, w, bias), 20)
            t_p = cuda_ms(lambda: geglu_matmul_plain(gx, gate, w, bias), 5)
            # yardstick, not the same function (exact erf, h not fused): the
            # two-call path a PyTorch user would write
            wt = w.t()
            t_u = cuda_ms(lambda: F.linear(gx * F.gelu(gate), wt, bias), 20)
            flops = 2.0 * m * kd * nd
            nbytes = (2 * m * kd + kd * nd + m * nd + nd) * isz
            b_ms = bound(flops, nbytes, dt)[0]
            extra = dict(variant=plan[0], tile=f"64/{plan[1]}" if plan[1] else None,
                         split=plan[2], r=-(-nd // plan[1]) if plan[1] else None,
                         tflops=flops / t_k / 1e9,
                         gbps=nbytes / t_k / 1e6, x_bound=t_k / b_ms, unfused_exact_erf_ms=t_u,
                         planted_rel=planted_rel)
            record("geglu", label, (m, kd, nd), dt, err, t_k, t_p, None, flops, nbytes,
                   tol[("geglu", dt)], row_tol[("geglu", dt)], **extra)
        del q, k, v, proj, gx, gate, w, wt, got, want
        for (m, kd, nd) in (quant_bf16 if dt == torch.bfloat16 else QUANT_F32):
            x = randn(m, kd, dtype=dt)
            for qname, (_, kname, plain, row_key) in qformats.items():
                leaf, dense = quant_leaf(kd, nd, qname)
                w, bias = leaf.w, leaf.bias.to(dt)
                fn = wrappers[kname]
                reset_counts()
                got = fn(x, w, bias)
                torch.cuda.synchronize()
                # the variant the plan names, and the one that ran
                plan = quant_plan(dt, m, kd, nd, w.group_size if qname == "int4" else None)
                ran = dict(fn.variants)
                if ran != {plan[0]: 1} or (dt == torch.bfloat16 and plan[0] != "wgmma"):
                    fail(f"{qname} ({m},{kd},{nd}) {dt}: launches by variant {ran}, plan "
                         f"{plan}; every main-path bf16 shape must run on wgmma")
                extra = dict(variant=plan[0], tile=plan[1], split=plan[2])
                want = plain(x, w, bias)
                err = rel_err(got, want)
                planted_rel = (rel_err(planted(x, w, bias), want)[1]
                               if dt == torch.bfloat16 else None)
                if qname == "int4" and dt == torch.bfloat16:
                    extra["planted_scale_rel"] = rel_err(planted(x, w, bias, "scale"), want)[1]
                t_k = cuda_ms(lambda: fn(x, w, bias), 20)
                t_p = cuda_ms(lambda: plain(x, w, bias), 5)
                wd = dense.to(dt)
                t_d = cuda_ms(lambda: F.linear(x, wd, bias), 20)
                t_l = lib_rel = None
                if qname in libraries and dt == torch.bfloat16:
                    lib_fn, why = libraries[qname][1](x, leaf)
                    if lib_fn is not None:
                        lib_rel = rel_err(lib_fn() + bias, want)[1]
                        if lib_rel > lib_tol:
                            lib_fn, why = None, f"differs from the plain version by {lib_rel:.3e}"
                    if lib_fn is None:
                        lib_notes.setdefault(qname, why)
                    else:
                        t_l = cuda_ms(lib_fn, 20)
                wbytes = kd * nd if qname != "int4" else kd * nd // 2 + 4 * nd * kd // 64
                nbytes = (m * kd + m * nd + nd) * isz + wbytes + (4 * nd if qname != "int4" else 0)
                flops = 2.0 * m * kd * nd
                extra.update(tflops=flops / t_k / 1e9, x_dense=t_k / t_d,
                             x_library=None if t_l is None else t_k / t_l)
                record(kname, f"{qname} ({m},{kd},{nd})", row_key(m, kd, nd), dt, err, t_k,
                       t_p, t_l, flops, nbytes, tol[("quant", dt)], row_tol[("quant", dt)],
                       dense_ms=t_d,
                       library_rel=lib_rel, planted_rel=planted_rel, **extra)
                del leaf, dense, wd, got, want
        del x
        torch.cuda.empty_cache()
    for qname, why in lib_notes.items():
        say(f"[kernel] library for {qname}: {libraries[qname][0]} not timed ({why}); "
            f"library_ms n/a")
    qrows = [r for kn in ("quant_matmul", "quant_matmul_int4") for r in report[kn].values()]
    worst = max(r["rel_err"] for r in qrows)
    caught = min(r["planted_rel"] for r in qrows)
    caught_scale = min(r["planted_scale_rel"] for r in report["quant_matmul_int4"].values())
    say(f"[kernel] quant matmuls bf16, tolerance {tol[('quant', torch.bfloat16)]:.0e}: "
        f"largest kernel error {worst:.3e}; smallest error of a planted rounding "
        f"deviation {caught:.3e} (int4 not rounded before the product, int8 / fp8 "
        f"scale folded into the weight), {caught_scale:.3e} (int4 scale rounded to bf16 "
        f"before the product)")
    if not min(caught, caught_scale) > tol[("quant", torch.bfloat16)]:
        fail("the quant-matmul tolerance does not catch a planted rounding deviation")
    grows = report["geglu"].values()
    say(f"[kernel] geglu bf16, tolerance {tol[('geglu', torch.bfloat16)]:.0e} (rows "
        f"{row_tol[('geglu', torch.bfloat16)]:.0e}): largest kernel error "
        f"{max(r['rel_err'] for r in grows):.3e} (worst row "
        f"{max(r['row_rel_err'] for r in grows):.3e}); smallest error of the planted "
        f"deviation (h kept in fp32 before the product) "
        f"{min(r['planted_rel'] for r in grows):.3e}")
    if not min(r["planted_rel"] for r in grows) > tol[("geglu", torch.bfloat16)]:
        fail("the geglu tolerance does not catch h left unrounded before the product")
    # the text towers' exact GELU (ops.gelu_erf: plain torch, no kernel of the
    # port) over every finite bf16 value, the card's result against the CPU's
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    xs = bits[torch.isfinite(bits)]
    gelu_card, gelu_cpu = gelu_erf(xs.to(dev)).cpu().float(), gelu_erf(xs).float()
    gelu_diff = gelu_card != gelu_cpu
    say(f"[gelu] ops.gelu_erf bf16 on the card against the CPU over all {xs.numel()} finite "
        f"bf16 values: {int(gelu_diff.sum())} differ; at x = "
        f"{xs[gelu_diff][:16].float().tolist()} (card {gelu_card[gelu_diff][:16].tolist()}, "
        f"CPU {gelu_cpu[gelu_diff][:16].tolist()})")
    # the functions repaired to JAX's bf16 arithmetic (plain torch, no kernel
    # of the port), over every finite bf16 value: the card must give the
    # CPU's bits, which the CPU tests hold to jax.jit of the JAX package
    xl_vae = sdxl.SDXL_BASE.vae
    repaired = {"sigmoid": ops.sigmoid, "silu": ops.silu, "quick_gelu": ops.quick_gelu,
                "gelu_tanh": ops.gelu_tanh}
    for tag, vcfg in (("SD1.x", sd.SD15.vae), ("SDXL", xl_vae), ("SD3", sd3.SD3_MEDIUM_CFG.vae)):
        repaired[f"vae.unscale_latent {tag} {vcfg.scale_factor}/{vcfg.shift_factor}"] = (
            functools.partial(vae_mod.unscale_latent, cfg=vcfg))
        repaired[f"vae.scale_latent {tag} {vcfg.scale_factor}/{vcfg.shift_factor}"] = (
            functools.partial(vae_mod.scale_latent, cfg=vcfg))
    for scale in (0.9, 1.0):
        repaired[f"controlnet.scaled {scale}"] = functools.partial(cn_mod.scaled, scale=scale)
    for fname, fn in repaired.items():
        card_v, cpu_v = fn(xs.to(dev)).cpu(), fn(xs)
        bad = ~((card_v == cpu_v) | (torch.isnan(card_v) & torch.isnan(cpu_v)))
        say(f"[repair] {fname} bf16 on the card against the CPU over all {xs.numel()} finite "
            f"bf16 values: {int(bad.sum())} differ; at x = {xs[bad][:8].float().tolist()}")
        if bad.any():
            fail(f"{fname}: the card's bf16 values differ from the CPU's at {int(bad.sum())}")
    # each format per image (launches x ms) against its library call, dense
    # cuBLAS and its bound: SD1.5's over all 19 shapes and over the M <= 154
    # ones (where the weight's bytes, not x's, dominate), SDXL-base's and the
    # quantized SD3 MMDiT's over theirs; the serving engine's per tick
    for qname, (_, kname, _, row_key) in qformats.items():
        for unit, label, image, keep in (
                ("image", "all 19 shapes", QUANT_SHAPES, lambda m: True),
                ("image", f"the {sum(m <= SMALL_M for m, _, _ in QUANT_SHAPES)} M <= {SMALL_M} "
                 f"shapes", QUANT_SHAPES, lambda m: m <= SMALL_M),
                ("image", f"SDXL-base's {len(sdxl_quant)} shapes", sdxl_quant, lambda m: True),
                ("image", f"the SD3 MMDiT's {len(MMDIT_QUANT_SHAPES)} shapes",
                 MMDIT_QUANT_SHAPES, lambda m: True),
                ("serving tick", f"the engine's {len(serve_quant)} batch-{2 * SERVE_SLOTS} "
                 f"shapes", serve_quant, lambda m: True)):
            rows = [(n, report[kname][row_key(m, k, nn)])
                    for (m, k, nn), n in image.items() if keep(m)]
            per = {f: sum(n * r[f] for n, r in rows) if all(r[f] is not None for _, r in rows)
                   else None for f in ("ms", "library_ms", "dense_ms", "bound_ms")}
            lib = "n/a" if per["library_ms"] is None else f"{per['library_ms']:.3f}"
            say(f"[kernel] {kname} {qname} per {unit} over {label}: kernel {per['ms']:.3f} ms, "
                f"library {lib}, dense {per['dense_ms']:.3f}, bound {per['bound_ms']:.3f} "
                f"({sum(n for n, _ in rows)} launches)")

    # [train-grad] the kernels' autograd Functions at the training shapes
    def grads(fn, inputs, cot):
        leaves = [x.detach().requires_grad_() for x in inputs]
        fn(*leaves).backward(cot)
        return [x.grad for x in leaves]

    grad_worst = {}
    for dt in (torch.bfloat16, torch.float32):
        cases = [("flash_packed", label, ((b, sq, c), (b, sk, c)), h, kvl)
                 for label, (b, sq, sk, c, h, kvl) in TRAIN_PACKED_SHAPES]
        bhsd_label, (bh, bsq, bsk, bd) = BHSD_SHAPES[0]  # off the training path
        cases.append(("flash_bhsd", bhsd_label, ((1, bh, bsq, bd), (1, bh, bsk, bd)), None,
                      None))
        for kname, label, (q_shape, k_shape), h, kvl in cases:
            q, cot = randn(*q_shape, dtype=dt), randn(*q_shape, dtype=dt)
            k, v = randn(*k_shape, dtype=dt), randn(*k_shape, dtype=dt)
            if kname == "flash_packed":
                fn = lambda q, k, v: flash_packed_diff(q, k, v, heads=h, kv_len=kvl)  # noqa: E731
                ref = lambda q, k, v: flash_packed_plain(q, k, v, heads=h, kv_len=kvl)  # noqa: E731
            else:
                fn, ref = flash_bhsd_diff, flash_bhsd_plain
            reset_counts()
            got = grads(fn, (q, k, v), cot)
            torch.cuda.synchronize()
            if wrappers[kname].launches != 1:
                fail(f"[train-grad] {kname} {label}: {wrappers[kname].launches} launches, want 1")
            want = grads(ref, (q, k, v), cot)
            rels = {n: rel_err(g_, w_)[1] for n, g_, w_ in zip("qkv", got, want)}
            grad_worst[(kname, dt)] = max(grad_worst.get((kname, dt), 0.0), *rels.values())
            say(f"[train-grad] {kname} {label} {str(dt)[6:]}: gradient rel err "
                f"{' '.join(f'd{n}={r:.3e}' for n, r in rels.items())} (tol {GRAD_TOL[dt]:.1e})")
            if not all(r <= GRAD_TOL[dt] for r in rels.values()) or not all(
                    g_.abs().sum() > 0 for g_ in got):
                fail(f"[train-grad] {kname} {label} {dt}: gradients {rels}")
            del q, k, v, cot, got, want
        for label, (m, kd, nd), _ in TRAIN_GEGLU_SHAPES:
            proj = randn(m, 2 * kd, dtype=dt)
            w = (randn(nd, kd, dtype=torch.float32) * kd ** -0.5).to(dt).t()
            bias, cot = randn(nd, dtype=dt), randn(m, nd, dtype=dt)

            def through(fn):
                p_, w_, b_ = (x.detach().requires_grad_() for x in (proj, w, bias))
                gx, gate = p_.chunk(2, dim=-1)  # strided halves, as in the UNet
                fn(gx, gate, w_, b_).backward(cot)
                return p_.grad[:, :kd], p_.grad[:, kd:], w_.grad, b_.grad

            reset_counts()
            got = through(geglu_matmul_diff)
            torch.cuda.synchronize()
            if geglu_matmul.launches != 1:
                fail(f"[train-grad] geglu {label}: {geglu_matmul.launches} launches, want 1")
            want = through(geglu_matmul_plain)
            rels = {n: rel_err(g_, w_)[1] for n, g_, w_ in zip(("gx", "gate", "w", "b"), got,
                                                                   want)}
            grad_worst[("geglu", dt)] = max(grad_worst.get(("geglu", dt), 0.0), *rels.values())
            say(f"[train-grad] geglu {label} ({m},{kd},{nd}) {str(dt)[6:]}: gradient rel err "
                f"{' '.join(f'd{n}={r:.3e}' for n, r in rels.items())} (tol {GRAD_TOL[dt]:.1e})")
            if not all(r <= GRAD_TOL[dt] for r in rels.values()):
                fail(f"[train-grad] geglu {label} {dt}: gradients {rels}")
            del proj, w, bias, cot, got, want
        torch.cuda.empty_cache()
    say(f"[train-grad] worst gradient rel err by kernel and dtype: "
        f"{ {f'{k} {str(d)[6:]}': round(v, 7) for (k, d), v in grad_worst.items()} }")

    stamp("3 (kernels)")

    # 4. kernels inside the model: UNet fp32, card vs CPU -----------------
    cfg = sd.SD15
    unet_gpu = unet_mod.UNet(cfg.unet, device=dev, dtype=torch.float32)
    init_weights(unet_gpu, seed=1)
    unet_cpu = unet_mod.UNet(cfg.unet, device="cpu", dtype=torch.float32)
    unet_cpu.load_state_dict(unet_gpu.state_dict())
    g_cpu = torch.Generator().manual_seed(2)
    x = torch.randn((2, 32, 32, 4), generator=g_cpu)
    ctx = torch.randn((2, 77, 768), generator=g_cpu)
    t = torch.full((2,), 981.0)
    reset_counts()
    with torch.inference_mode():
        got = unet_mod.apply(unet_gpu, x.to(dev), t.to(dev), ctx.to(dev))
        torch.cuda.synchronize()
        n_packed, n_geglu = flash_packed.launches, geglu_matmul.launches
        want = unet_mod.apply(unet_cpu, x, t, ctx)
    err = rel_err(got.cpu(), want)
    # fp32 throughout, TF32 off: only summation order differs (cuDNN and
    # the kernels against the CPU's), compounded over ~70 layers.
    unet_tol = 1e-3
    say(f"[unet] SD1.5 UNet fp32 256x256 (2,32,32,4): card vs CPU max_abs={err[0]:.3e} "
        f"rel={err[1]:.3e} (tol {unet_tol:.0e}); kernel launches on the card: "
        f"flash_packed={n_packed} geglu={n_geglu}")
    if not (err[1] <= unet_tol and n_packed == 10 and n_geglu == 16):
        fail("UNet forward on the card disagrees with the CPU or skipped a kernel")
    del unet_cpu, got, want
    for qname in ("int8", "int4"):
        qdtype, kname = qformats[qname][:2]
        # quantized on the card, then the same buffers moved to the CPU
        q_gpu = quantize_params(copy.deepcopy(unet_gpu), qdtype)
        q_cpu = copy.deepcopy(q_gpu).to("cpu")
        reset_counts()
        with torch.inference_mode():
            got = unet_mod.apply(q_gpu, x.to(dev), t.to(dev), ctx.to(dev))
            torch.cuda.synchronize()
            counts = {kn: w.launches for kn, w in wrappers.items()}
            want = unet_mod.apply(q_cpu, x, t, ctx)
        err = rel_err(got.cpu(), want)
        say(f"[unet] SD1.5 UNet fp32 256x256 {qname} weights: card vs CPU max_abs="
            f"{err[0]:.3e} rel={err[1]:.3e} (tol {unet_tol:.0e}); kernel launches on the "
            f"card: {counts}")
        expect = dict.fromkeys(wrappers, 0)
        expect.update(flash_packed=10, **{kname: 184})
        if not (err[1] <= unet_tol and counts == expect):
            fail(f"{qname} UNet forward on the card disagrees with the CPU or its "
                 f"launches {counts} are not {expect}")
        del q_gpu, q_cpu, got, want
    del unet_gpu
    torch.cuda.empty_cache()

    # 4s. the MMDiT: SD3-medium at full width, fp32, card vs CPU ----------
    mcfg = sd3.SD3_MEDIUM_CFG.mmdit
    mm_gpu = mmdit_mod.MMDiT(mcfg, device=dev, dtype=torch.float32)
    init_weights(mm_gpu, seed=4)
    fill_zero_init(mm_gpu, seed=5)
    mm_cpu = mmdit_mod.MMDiT(mcfg, device="cpu", dtype=torch.float32)
    mm_cpu.load_state_dict(mm_gpu.state_dict())
    g_cpu = torch.Generator().manual_seed(6)
    x = torch.randn((2, 64, 64, 16), generator=g_cpu)
    t = torch.rand((2,), generator=g_cpu)
    ctx = torch.randn((2, 77, 4096), generator=g_cpu)
    pooled = torch.randn((2, 2048), generator=g_cpu)
    reset_counts()
    with torch.inference_mode():
        got = mmdit_mod.apply(mm_gpu, x.to(dev), t.to(dev), ctx.to(dev), pooled.to(dev))
        torch.cuda.synchronize()
        counts = {kn: w.launches for kn, w in wrappers.items()}
        mm_shapes = dict(flash_packed.shapes)
        t0 = time.perf_counter()
        want = mmdit_mod.apply(mm_cpu, x, t, ctx, pooled)
        cpu_s = time.perf_counter() - t0
    err = rel_err(got.cpu(), want)
    mm_tol = 1e-3  # fp32, TF32 off: summation order only, over 24 blocks
    say(f"[mmdit] SD3-medium MMDiT fp32, latent (2,64,64,16), 77 text tokens: card vs "
        f"CPU max_abs={err[0]:.3e} rel={err[1]:.3e} (tol {mm_tol:.0e}); kernel launches "
        f"on the card: {counts}, flash_packed shapes {mm_shapes}; CPU forward {cpu_s:.1f} s")
    expect = dict.fromkeys(wrappers, 0)
    expect["flash_packed"] = mcfg.depth
    if not (err[1] <= mm_tol and counts == expect
            and mm_shapes == {(2, 1152, 1152, 1536, 24, 1101): mcfg.depth}):
        fail("MMDiT forward on the card disagrees with the CPU or its launches are not "
             f"{expect} at (2, 1152, 1152, 1536, 24, 1101)")
    del mm_gpu, mm_cpu, got, want
    torch.cuda.empty_cache()

    # 4v. the SD2.1 UNet: full width, fp32, card vs CPU --------------------
    # 32x32 latents, so that the 1024-token level takes flash_packed at d = 64
    ucfg21 = sd.SD21_V.unet
    u21_gpu = unet_mod.UNet(ucfg21, device=dev, dtype=torch.float32)
    init_weights(u21_gpu, seed=13)
    u21_cpu = unet_mod.UNet(ucfg21, device="cpu", dtype=torch.float32)
    u21_cpu.load_state_dict(u21_gpu.state_dict())
    g_cpu = torch.Generator().manual_seed(14)
    x = torch.randn((2, 32, 32, 4), generator=g_cpu)
    ctx = torch.randn((2, 77, ucfg21.context_dim), generator=g_cpu)
    t = torch.full((2,), 801.0)
    reset_counts()
    with torch.inference_mode():
        got = unet_mod.apply(u21_gpu, x.to(dev), t.to(dev), ctx.to(dev))
        torch.cuda.synchronize()
        counts = {kn: w.launches for kn, w in wrappers.items()}
        u21_shapes = dict(flash_packed.shapes)
        t0 = time.perf_counter()
        want = unet_mod.apply(u21_cpu, x, t, ctx)
        cpu_s = time.perf_counter() - t0
    err = rel_err(got.cpu(), want)
    say(f"[unet-sd21] SD2.1 UNet (64-wide heads, context 1024) fp32 256x256 (2,32,32,4): "
        f"card vs CPU max_abs={err[0]:.3e} rel={err[1]:.3e} (tol {unet_tol:.0e}); kernel "
        f"launches on the card: {counts}, flash_packed shapes {u21_shapes}; CPU forward "
        f"{cpu_s:.1f} s")
    expect = dict.fromkeys(wrappers, 0)
    expect.update(flash_packed=10, geglu=16)
    if not (err[1] <= unet_tol and counts == expect
            and u21_shapes == {(2, 1024, 1024, 320, 5, 1024): 5, (2, 1024, 77, 320, 5, 77): 5}):
        fail(f"SD2.1 UNet forward on the card disagrees with the CPU or its launches are not "
             f"{expect} with flash_packed at 5 heads of 64")
    del u21_gpu, u21_cpu, got, want
    torch.cuda.empty_cache()

    stamp("4, 4s, 4v (models, card vs CPU)")

    # 4d. DiT-XL/2: fp32 card vs CPU at 256x256 (the math route) and at
    # 512x512 (class-conditional, flash_packed at d = 72); then bf16 CFG
    # forwards, timed --------------------------------------------------------
    dit_cfgs = {"256": dit_mod.DIT_XL_2,
                "512": dataclasses.replace(dit_mod.DIT_XL_2, input_size=64, num_classes=1000)}
    extra_paths = {}  # path -> (launches by wrapper, by wrapper and shape)
    dit_forward_ms = {}
    for size, dcfg in dit_cfgs.items():
        d_gpu = dit_mod.DiT(dcfg, device=dev, dtype=torch.float32, seed=51)
        fill_zero_init(d_gpu, 52)
        d_cpu = dit_mod.DiT(dcfg, device="cpu", dtype=torch.float32, seed=None)
        d_cpu.load_state_dict(d_gpu.state_dict())
        g_cpu = torch.Generator().manual_seed(53)
        side = dcfg.input_size
        x = torch.randn((2, side, side, dcfg.in_channels), generator=g_cpu)
        t = torch.tensor([981.0, 21.0])
        kw = {"labels": torch.tensor([207, dcfg.num_classes])} if dcfg.num_classes else {}
        reset_counts()
        with torch.inference_mode():
            got = dit_mod.apply(d_gpu, x.to(dev), t.to(dev), **{k: v.to(dev) for k, v in kw.items()})
            torch.cuda.synchronize()
            counts = {kn: w.launches for kn, w in wrappers.items()}
            shapes_d = dict(flash_packed.shapes)
            t0 = time.perf_counter()
            want = dit_mod.apply(d_cpu, x, t, **kw)
            cpu_s = time.perf_counter() - t0
        err = rel_err(got.cpu(), want)
        n_tok = (side // dcfg.patch_size) ** 2
        expect = dict.fromkeys(wrappers, 0)
        want_shapes_d = {}
        if n_tok >= 1024:
            expect["flash_packed"] = dcfg.depth
            want_shapes_d = {(2, n_tok, n_tok, dcfg.dim, dcfg.num_heads, n_tok): dcfg.depth}
        say(f"[dit] DiT-XL/2 {side * 8}x{side * 8} ({n_tok} tokens, {dcfg.depth} blocks"
            f"{', 1000 classes' if dcfg.num_classes else ''}) fp32: card vs CPU max_abs="
            f"{err[0]:.3e} rel={err[1]:.3e} (tol {mm_tol:.0e}); kernel launches on the card: "
            f"{counts}, flash_packed shapes {shapes_d}; CPU forward {cpu_s:.1f} s")
        if not (err[1] <= mm_tol and counts == expect and shapes_d == want_shapes_d):
            fail(f"DiT {size}: the card disagrees with the CPU or its launches {counts} "
                 f"{shapes_d} are not {expect} {want_shapes_d}")
        del d_gpu, d_cpu, got, want
        # bf16: one counted CFG forward, then DIT_FORWARDS timed
        d16 = dit_mod.DiT(dcfg, device=dev, dtype=torch.bfloat16, seed=54)
        fill_zero_init(d16, 55)
        x16 = x.to(dev, torch.bfloat16)
        kw16 = {k: v.to(dev) for k, v in kw.items()}

        def forward():
            with torch.inference_mode():
                return dit_mod.apply(d16, x16, t.to(dev), **kw16)

        out16 = forward()  # warm
        torch.cuda.synchronize()
        reset_counts()
        out16 = forward()
        torch.cuda.synchronize()
        counts = {kn: w.launches for kn, w in wrappers.items()}
        counted = {kn: dict(w.shapes) for kn, w in wrappers.items()}
        by_variant = variants()
        want_counts = dict.fromkeys(wrappers, 0)
        want_counts["flash_packed"] = dcfg.depth if n_tok >= 1024 else 0
        if (counts != want_counts or not torch.isfinite(out16.float()).all()
                or set(counted["flash_packed"]) - measured("flash_packed")
                or set(by_variant["flash_packed"]) - set(WGMMA)):
            fail(f"DiT {size} bf16: launches {counts} (want {want_counts}), shapes {counted}, "
                 f"variants {by_variant}, or a non-finite output")
        t0 = time.perf_counter()
        for _ in range(DIT_FORWARDS):
            forward()
        torch.cuda.synchronize()
        dit_forward_ms[size] = (time.perf_counter() - t0) / DIT_FORWARDS * 1e3
        prof = profile(lambda: [forward() for _ in range(3)])
        say(f"[dit] DiT-XL/2 {side * 8}x{side * 8} bf16 CFG forward (batch 2, {dcfg.depth} "
            f"blocks): {dit_forward_ms[size]:.3f} ms a forward over {DIT_FORWARDS}; launches "
            f"in one forward {counts}, flash_packed shapes {counted['flash_packed']} by variant "
            f"{by_variant['flash_packed']}; 3 forwards under torch.profiler: host "
            f"{prof['host_s']:.3f} s, device {prof['device_ms']:.1f} ms in "
            f"{prof['device_kernels']} kernels, busy share {prof['device_busy_share']:.3f}, by "
            f"group {json.dumps(prof['groups_ms'])}; card {card}")
        extra_paths[f"dit_{size}"] = (counts, counted)
        del d16, x16, out16, forward
        torch.cuda.empty_cache()

    stamp("4d (DiT-XL/2)")

    # 4e. the CLIP scorer's ViT-L/14: fp32 (TF32 off), card vs CPU on 512x512
    # uint8 images through preprocess (antialiased resize to 224x224); then
    # the scorer's image path timed on a batch ------------------------------
    from tinyfusers_tpu_torch.eval import clip_score as cs_mod
    from tinyfusers_tpu_torch.models import clip_vision as cv_mod

    vit_gpu = cv_mod.CLIPVisionModel(cv_mod.VIT_L_14, device=dev, seed=61)
    vit_cpu = cv_mod.CLIPVisionModel(cv_mod.VIT_L_14, device="cpu", seed=None)
    vit_cpu.load_state_dict(vit_gpu.state_dict())
    g_cpu = torch.Generator().manual_seed(62)
    vit_imgs = torch.randint(0, 256, (VIT_CHECK_IMAGES, 512, 512, 3), generator=g_cpu,
                             dtype=torch.uint8)
    reset_counts()
    with torch.inference_mode():
        px_gpu = cv_mod.preprocess(vit_imgs.to(dev))
        got = cv_mod.apply(vit_gpu, px_gpu)
        torch.cuda.synchronize()
        counts = {kn: w.launches for kn, w in wrappers.items()}
        t0 = time.perf_counter()
        px_cpu = cv_mod.preprocess(vit_imgs)
        want = cv_mod.apply(vit_cpu, px_cpu)
        cpu_s = time.perf_counter() - t0
    err = rel_err(got.cpu(), want)
    px_err = (px_gpu.cpu() - px_cpu).abs().max().item()
    # fp32, TF32 off: summation order only, over 24 layers. The antialiased
    # resize: CUDA's kernel forms its filter weights otherwise than the
    # CPU's (1.6e-5 apart on the normalized pixels on an H100, ~1e-6 on the
    # CPU against jax.image.resize), while a resize without the antialias
    # filter moves them by ~2
    vit_tol, px_tol = 1e-4, 1e-4
    batch = torch.randint(0, 256, (VIT_BATCH, 512, 512, 3), generator=g_cpu,
                          dtype=torch.uint8).to(dev)

    def scorer_images():  # the scorer's image path: preprocess, then the tower
        with torch.inference_mode():
            return cv_mod.apply(vit_gpu, cv_mod.preprocess(batch))

    scorer_images()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        scorer_images()
    end.record()
    end.synchronize()
    vit_ms = start.elapsed_time(end) / 5
    vit_flops = 2.0 * VIT_BATCH * (cv_mod.VIT_L_14.num_patches + 1) * sum(
        p.numel() for p in vit_gpu.layers.parameters())
    say(f"[vit] CLIP ViT-L/14 fp32 (TF32 off), {VIT_CHECK_IMAGES} uint8 512x512 images "
        f"preprocessed to 224x224: card vs CPU max_abs={err[0]:.3e} rel={err[1]:.3e} (tol "
        f"{vit_tol:.0e}), pixels max_abs={px_err:.3e} (tol {px_tol:.0e}); kernel launches on "
        f"the card: {counts} (257 tokens: the math route); CPU forward {cpu_s:.1f} s; one "
        f"{VIT_BATCH}-image batch (preprocess + tower) {vit_ms:.3f} ms by events over 5, "
        f"{vit_flops / vit_ms / 1e9:.1f} TFLOP/s in its layers' weight matmuls; card {card}")
    if not (err[1] <= vit_tol and px_err <= px_tol and not any(counts.values())
            and got.shape == (VIT_CHECK_IMAGES, 768)):
        fail("the ViT-L/14 scorer on the card disagrees with the CPU, or launched a kernel")
    del vit_gpu, vit_cpu, got, want, px_gpu, px_cpu, batch
    torch.cuda.empty_cache()

    stamp("4e (the CLIP scorer's ViT-L/14)")

    # 5. the main path ----------------------------------------------------
    dtype = torch.bfloat16
    t0 = time.perf_counter()
    model = sd.StableDiffusion(cfg, device=dev, dtype=dtype, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids, uncond = sd15_prompt(dev)
    latent = sd.initial_latent(4, 1, cfg, device=dev, dtype=dtype)

    with torch.inference_mode():  # warm-up through the pipeline's stages
        c, uc = sd.encode_text(model, ids), sd.encode_text(model, uncond)
        lat = sd.sample_latents(model.unet, latent, c, uc, num_steps=STEPS,
                                guidance=GUIDANCE)
        warm_img = vae_mod.to_image(vae_mod.decode(model.vae, lat))
        torch.cuda.synchronize()
    if lat.shape != (1, 64, 64, 4) or not torch.isfinite(lat.float()).all():
        fail(f"latents {tuple(lat.shape)} not finite of shape (1, 64, 64, 4)")
    say(f"[main] warm-up: weights made on the card in {init_s:.2f} s; latents "
        f"finite, |lat| max {lat.float().abs().max().item():.3f}")

    held_gb = torch.cuda.memory_allocated() / 1e9  # weights and the warm-up's outputs
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for i in range(3):
        if i == 0:
            reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = sd.generate(model, ids, uncond, latent, GUIDANCE, num_steps=STEPS)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if i == 0:
            launches = {kname: w.launches for kname, w in wrappers.items()}
            shapes = {kname: dict(w.shapes) for kname, w in wrappers.items()}
            path_variants = variants()
            first = img
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if img.dtype != torch.uint8 or tuple(img.shape) != (1, 512, 512, 3):
        fail(f"image {img.dtype} {tuple(img.shape)}, want uint8 (1, 512, 512, 3)")
    want = {"flash_packed": 400, "flash_bhsd": 1, "geglu": 320, "quant_matmul": 0,
            "quant_matmul_int4": 0}
    want_variants = {"flash_packed": {"wgmma": 400}, "flash_bhsd": {"wgmma_wide": 1},
                     "geglu": {"wgmma": 320}}
    say(f"[main] launches in one image: {launches} (want {want}); flash and geglu launches "
        f"by variant {path_variants}")
    if launches != want or path_variants != want_variants:
        fail("the main path did not launch each kernel the expected number of times "
             f"on the expected variants ({want_variants})")
    for kname, counted in shapes.items():
        unmeasured = set(counted) - measured(kname)
        if unmeasured or sum(counted.values()) != launches[kname]:
            fail(f"{kname}: main-path shapes {counted} against phase 3's {measured(kname)}")
    diff = (first.int() - warm_img.int()).abs().max().item()
    say(f"[main] SD1.5 512x512 {STEPS}-step DDIM CFG {GUIDANCE} bf16 batch 1: "
        f"s/image {[round(s, 4) for s in secs]} mean {sum(secs) / 3:.4f}; peak device "
        f"memory {peak_gb:.2f} GB ({held_gb:.2f} GB held before the images); image max diff vs warm-up {diff}; card {card}")

    # [parallel-1] the same image through generate on a one-rank NCCL mesh:
    # shard_params changes nothing at model = 1 and the data axis keeps
    # every row, so the image and the launches must be phase 5's bit for bit
    import torch.distributed as dist

    from tinyfusers_tpu_torch import parallel

    t_par = time.perf_counter()
    store = Path(tempfile.mkdtemp(prefix="tf_parallel_"))
    dist.init_process_group("nccl", init_method=f"file://{store / 'store'}", rank=0,
                            world_size=1)
    mesh1 = parallel.make_mesh(model=1)
    parallel.shard_params(model, mesh1)
    reset_counts()
    p_img = sd.generate(model, ids, uncond, latent, GUIDANCE, num_steps=STEPS, mesh=mesh1)
    torch.cuda.synchronize()
    p_counts = {kname: w.launches for kname, w in wrappers.items()}
    p_shapes = {kname: dict(w.shapes) for kname, w in wrappers.items()}
    dist.destroy_process_group()
    same = torch.equal(p_img, first)
    say(f"[parallel-1] SD1.5 512x512 {STEPS}-step DDIM CFG {GUIDANCE} bf16 through "
        f"generate(mesh=) on a (data 1, model 1) NCCL mesh: image equal to phase 5's bit "
        f"for bit: {same}; launches {p_counts} (phase 5: {launches}); launches by shape "
        f"equal phase 5's: {p_shapes == shapes}; "
        f"{time.perf_counter() - t_par:.1f} s wall")
    if not same or p_counts != launches or p_shapes != shapes:
        fail("[parallel-1] the one-rank mesh's image or launches differ from phase 5's")
    extra_paths["parallel_1"] = (p_counts, p_shapes)

    # [parallel-tp2] two ranks on the one card (parallel_rank): NCCL takes
    # one rank per device, so the ranks' group is gloo over CUDA tensors (its
    # all_reduce, all_gather and broadcast take them; the compute stays on
    # the card, the transfers go through the host)
    t_par = time.perf_counter()
    torch.cuda.empty_cache()
    import torch.multiprocessing as tmp_mp

    try:
        tmp_mp.start_processes(parallel_rank, args=(2, str(store / "store2"), str(store)),
                               nprocs=2, join=True, start_method="spawn")
    except Exception as e:  # noqa: BLE001  (a rank's traceback)
        fail(f"[parallel-tp2] a rank failed: {e}")
    tp2 = [json.loads((store / f"rank{r}.json").read_text()) for r in range(2)]
    shutil.rmtree(store, ignore_errors=True)
    # each part's tag; the new paths' wants are each rank's own (the serving
    # engine on the data axis runs other slots on each rank)
    tags = {"forward_fp32": "parallel-tp2", "forward_bf16": "parallel-tp2",
            "train_tp": "parallel-tp2", "train_fsdp": "parallel-tp2",
            "ada_tp": "parallel-adafactor", "ada_fsdp": "parallel-adafactor",
            "gen_ancestral": "parallel-gen", "cn_image": "parallel-cn",
            "ring_image": "parallel-ring", "ring_mmdit_float32": "parallel-ring",
            "ring_mmdit_bfloat16": "parallel-ring", "pipe_float32": "parallel-pipe",
            "pipe_bfloat16": "parallel-pipe", "serve_data2": "serve-mesh",
            "serve_model2": "serve-mesh", "serve_data2_bf16": "serve-mesh",
            "serve_model2_bf16": "serve-mesh", "serve_router": "serve-mesh"}
    for part, tag in tags.items():
        res = tp2[0][part]
        by_rank = [r[part]["launches"] for r in tp2]
        say(f"[{tag}] {res['what']}: rank 0: {res['check']}; rank 1: "
            f"{tp2[1][part]['check']}; launches per rank {by_rank} (want "
            f"{[r[part]['want'] for r in tp2]}); {res['seconds']:.2f} s")
        for i, r in enumerate(tp2):
            if not r[part]["ok"]:
                fail(f"[{tag}] {part} rank {i}: {r[part]['check']}")
            got, want = r[part]["launches"], r[part]["want"]
            if {kn: got.get(kn, 0) for kn in want} != want:
                fail(f"[{tag}] {part} rank {i}: launches {got}, want {want}")
            for kn, by_shape in r[part]["shapes"].items():
                if {tuple(json.loads(k)) for k in by_shape} - measured(kn):
                    fail(f"[{tag}] {part} {kn}: shapes {by_shape} not all measured in "
                         f"phase 3")
    for group, tag in (("adafactor", "parallel-adafactor"), ("gen", "parallel-gen"),
                       ("cn", "parallel-cn"), ("ring", "parallel-ring"),
                       ("pipe", "parallel-pipe"), ("serve", "serve-mesh")):
        say(f"[{tag}] wall {tp2[0]['wall'][group]:.1f} s on rank 0 (model builds included); "
            f"transport between the two gloo ranks on the card through host memory; card "
            f"{card}")

    def both_ranks(part):  # (launches by wrapper, by wrapper and shape), both ranks'
        return ({kn: sum(r[part]["launches"].get(kn, 0) for r in tp2) for kn in wrappers},
                {kn: {tuple(json.loads(k)): sum(r[part]["shapes"].get(kn, {}).get(k, 0)
                                                for r in tp2)
                      for k in {k for r in tp2 for k in r[part]["shapes"].get(kn, {})}}
                 for kn in wrappers})

    # the bf16 parts' launches join the kernels line (both ranks'): the TP
    # forward's and, under flash_packed_multik, the pipelined MMDiT's
    extra_paths["parallel_tp2"] = both_ranks("forward_bf16")
    pipe_multik = both_ranks("pipe_bfloat16")
    say(f"[parallel-tp2] two gloo ranks on the card, transport through host memory: "
        f"{time.perf_counter() - t_par:.1f} s wall for all of its parts and [parallel-ring], "
        f"[parallel-pipe] and [serve-mesh]; card {card}")
    stamp("5, 5p (SD1.5 dense, parallel)")

    # 6. profile: one more image, same model and inputs -------------------
    prof = profile(lambda: sd.generate(model, ids, uncond, latent, GUIDANCE,
                                       num_steps=STEPS), host_ops=True)
    say(f"[profile] one SD1.5 image under torch.profiler: {json.dumps(prof)}")

    # 5q. the main path with the UNet quantized on the card ---------------
    # The same bf16 UNet weights, restored dense on the card for each format
    # and quantized there in place by quantize_params, as a user would.
    dense_state = {key: v.to("cpu") for key, v in model.unet.state_dict().items()}
    dense_lat = lat.float()
    q_launches, q_shapes = {}, {}
    for qname, (qdtype, kname, _, row_key) in qformats.items():
        model.unet = None
        torch.cuda.empty_cache()
        unet_q = unet_mod.UNet(cfg.unet, device=dev, dtype=dtype)
        unet_q.load_state_dict(dense_state)
        model.unet = quantize_params(unet_q, qdtype)
        del unet_q
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held_gb = torch.cuda.memory_allocated() / 1e9  # weights of all three models
        with torch.inference_mode():  # warm-up
            qlat = sd.sample_latents(model.unet, latent, c, uc, num_steps=STEPS,
                                     guidance=GUIDANCE)
            torch.cuda.synchronize()
        if qlat.shape != (1, 64, 64, 4) or not torch.isfinite(qlat.float()).all():
            fail(f"{qname}: latents {tuple(qlat.shape)} not finite of shape (1, 64, 64, 4)")
        lat_rel = ((qlat.float() - dense_lat).norm() / dense_lat.norm()).item()
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for i in range(PATH_IMAGES):
            if i == 0:
                reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = sd.generate(model, ids, uncond, latent, GUIDANCE, num_steps=STEPS)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if i == 0:
                counts = {kn: w.launches for kn, w in wrappers.items()}
                counted = {kn: dict(w.shapes) for kn, w in wrappers.items()}
                q_variants = variants()
                quant_variants = {kn: dict(wrappers[kn].variants)
                                  for kn in ("quant_matmul", "quant_matmul_int4")}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if img.dtype != torch.uint8 or tuple(img.shape) != (1, 512, 512, 3):
            fail(f"{qname} image {img.dtype} {tuple(img.shape)}, want uint8 (1, 512, 512, 3)")
        want = {"flash_packed": 400, "flash_bhsd": 1, "geglu": 0, "quant_matmul": 0,
                "quant_matmul_int4": 0}
        want[kname] = sum(QUANT_SHAPES.values())
        want_shapes = {row_key(*mkn): n for mkn, n in QUANT_SHAPES.items()}
        want_quant = {"quant_matmul": {}, "quant_matmul_int4": {}}
        want_quant[kname] = {"wgmma": want[kname]}
        say(f"[main-{qname}] launches in one image: {counts} (want {want}); flash "
            f"launches by variant {q_variants}; quant launches by variant {quant_variants} "
            f"(want {want_quant})")
        if (counts != want or counted[kname] != want_shapes
                or q_variants != dict(want_variants, geglu={})
                or quant_variants != want_quant):
            fail(f"{qname}: launches {counts}, shapes {counted[kname]} against {want}, "
                 f"{want_shapes}")
        for kn in ("flash_packed", "flash_bhsd"):
            if set(counted[kn]) - measured(kn):
                fail(f"{qname} {kn}: main-path shapes {counted[kn]} not all measured")
        if set(want_shapes) - measured(kname):
            fail(f"{qname}: a main-path shape of {kname} was not measured in phase 3")
        q_launches[qname], q_shapes[qname] = counts[kname], counted[kname]
        say(f"[main-{qname}] SD1.5 512x512 {STEPS}-step DDIM CFG {GUIDANCE} bf16 batch 1, "
            f"UNet weights {qname}: s/image {[round(x, 4) for x in secs]} mean "
            f"{sum(secs) / len(secs):.4f}; peak device memory {peak_gb:.2f} GB ({held_gb:.2f} GB "
            f"held before the images); final latents vs the dense image's: rel "
            f"{lat_rel:.4e}; card {card}")
        if qname == "int8":
            # wgmma reads the model's bf16 bias as it is: one cast launch
            # per biased call fewer than an fp32 copy would take
            has_bias = [leaf.bias is not None for leaf in model.unet.modules()
                        if isinstance(leaf, Linear) and is_quantized(leaf.w)]
            say(f"[main-int8] {len(has_bias)} quantized Linear leaves ({len(has_bias) * STEPS} "
                f"calls per image), {sum(has_bias)} with a bf16 bias: {sum(has_bias) * STEPS} "
                f"bias casts per image not launched")
            # 6q. profile: one int8 image
            prof = profile(lambda: sd.generate(model, ids, uncond, latent, GUIDANCE,
                                               num_steps=STEPS))
            say(f"[profile] one SD1.5 image with int8 UNet weights under torch.profiler: "
                f"{json.dumps(prof)}")

    # 6q. profile: one int4 image -------------------------------------------
    prof = profile(lambda: sd.generate(model, ids, uncond, latent, GUIDANCE,
                                       num_steps=STEPS))
    say(f"[profile] one SD1.5 image with int4 UNet weights under torch.profiler: "
        f"{json.dumps(prof)}")
    del model, c, uc, lat, qlat, warm_img, first, img, dense_state, dense_lat
    torch.cuda.empty_cache()

    stamp("6, 5q, 6q (SD1.5 profile and quantized)")

    # 5s / 6s / 5t. the SD3 main paths ---------------------------------------
    g_ids = torch.Generator().manual_seed(7)

    def clip_ids(n_words):  # BOS, words, then EOT (vocab_size - 1) as padding
        tok = torch.full((1, 77), 49407, dtype=torch.long)
        tok[0, 0] = 49406
        tok[0, 1:1 + n_words] = torch.randint(0, 49406, (n_words,), generator=g_ids)
        return tok.to(dev)

    def t5_ids(n_words):  # words, EOS (1), then padding (0)
        tok = torch.zeros((1, 77), dtype=torch.long)
        tok[0, :n_words] = torch.randint(2, 32128, (n_words,), generator=g_ids)
        tok[0, n_words] = 1
        return tok.to(dev)

    bhsd_1024 = (1, 16384, 16384, 512)

    def sd3_images(tag, cfg3, seed, n_images, joint_key, model3=None):
        """Weights made on the card (adaLN leaves filled), or ``model3`` as
        it is, a warm-up through the stages, then n_images images, the first
        with its launches counted and checked exactly. Returns the model, the
        image call and the first image's counts by wrapper and by shape."""
        t0 = time.perf_counter()
        if model3 is None:
            model3 = sd3.StableDiffusion3(cfg3, device=dev, dtype=dtype, seed=seed)
            fill_zero_init(model3.mmdit, seed + 1)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        ids_l, ids_g, uids = clip_ids(8), clip_ids(8), clip_ids(0)
        t5 = {} if cfg3.t5 is None else dict(ids_t5=t5_ids(8), uids_t5=t5_ids(0))
        latent3 = sd3.initial_latent(seed + 2, 1, cfg3, device=dev, dtype=dtype)

        def run():
            return sd3.generate(model3, ids_l, ids_g, uids, uids, latent3, SD3_GUIDANCE,
                                num_steps=SD3_STEPS, **t5)

        with torch.inference_mode():  # warm-up through the pipeline's stages
            cc, pc = sd3.encode_text(model3, ids_l, ids_g, t5.get("ids_t5"))
            cu, pu = sd3.encode_text(model3, uids, uids, t5.get("uids_t5"))
            lat3 = sd3.sample_latents(model3.mmdit, latent3, torch.cat([cu, cc]).to(dtype),
                                      torch.cat([pu, pc]).to(dtype), SD3_GUIDANCE,
                                      num_steps=SD3_STEPS, shift=cfg3.shift)
            warm = vae_mod.to_image(vae_mod.decode(model3.vae, lat3))
            torch.cuda.synchronize()
        lat_shape = (1, *cfg3.latent_shape)
        if tuple(lat3.shape) != lat_shape or not torch.isfinite(lat3.float()).all():
            fail(f"{tag}: latents {tuple(lat3.shape)} not finite of shape {lat_shape}")
        moved = (lat3.float() - latent3.float()).norm() / latent3.float().norm()
        say(f"[{tag}] warm-up: weights made on the card in {init_s:.2f} s; context "
            f"{tuple(cc.shape)}, pooled {tuple(pc.shape)}; latents finite, |lat| max "
            f"{lat3.float().abs().max().item():.3f}, moved from the noise by rel "
            f"{moved.item():.3f}")
        held_gb = torch.cuda.memory_allocated() / 1e9  # weights and the warm-up's outputs
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for i in range(n_images):
            if i == 0:
                reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img3 = run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if i == 0:
                counts3 = {kn: w.launches for kn, w in wrappers.items()}
                counted3 = {kn: dict(w.shapes) for kn, w in wrappers.items()}
                variants3 = variants()
                first3 = img3
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if img3.dtype != torch.uint8 or tuple(img3.shape) != (1, 1024, 1024, 3):
            fail(f"{tag}: image {img3.dtype} {tuple(img3.shape)}, want uint8 (1, 1024, 1024, 3)")
        n_joint = SD3_STEPS * cfg3.mmdit.depth
        want = dict.fromkeys(wrappers, 0)
        want.update(flash_packed=n_joint, flash_bhsd=1)
        want_shapes = {kn: {} for kn in wrappers}
        want_shapes.update(flash_packed={joint_key: n_joint}, flash_bhsd={bhsd_1024: 1})
        want_variants3 = {"flash_packed": {"wgmma": n_joint}, "flash_bhsd": {"wgmma_wide": 1},
                          "geglu": {}}
        say(f"[{tag}] launches in one image: {counts3} (want {want}); shapes "
            f"flash_packed {counted3['flash_packed']}, flash_bhsd {counted3['flash_bhsd']}; "
            f"flash launches by variant {variants3}")
        if counts3 != want or counted3 != want_shapes or variants3 != want_variants3:
            fail(f"{tag}: launches {counts3}, shapes {counted3} against {want}, {want_shapes}")
        for kn, by_shape in counted3.items():
            if set(by_shape) - measured(kn):
                fail(f"{tag} {kn}: main-path shapes {by_shape} not all measured in phase 3")
        diff = (first3.int() - warm.int()).abs().max().item()
        say(f"[{tag}] SD3-medium{' + T5-XXL' if cfg3.t5 else ''} 1024x1024 {SD3_STEPS}-step "
            f"Euler flow CFG {SD3_GUIDANCE} bf16 batch 1: image {tuple(img3.shape)} "
            f"{str(img3.dtype)[6:]}; s/image {[round(x, 4) for x in secs]} mean "
            f"{sum(secs) / len(secs):.4f}; peak device memory {peak_gb:.2f} GB "
            f"({held_gb:.2f} GB held before the images); image max diff vs warm-up "
            f"{diff}; card {card}")
        return model3, run, counts3, counted3

    model3, run3, sd3_launches, sd3_shapes = sd3_images(
        "main-sd3", sd3.SD3_MEDIUM_CFG, 8, PATH_IMAGES, MULTIK_SHAPES[0][1])
    prof = profile(run3)
    say(f"[profile] one SD3-medium 1024x1024 image under torch.profiler: {json.dumps(prof)}")
    del model3, run3
    torch.cuda.empty_cache()
    model3, run3, t5_launches, t5_shapes = sd3_images(
        "main-sd3-t5", sd3.SD3_MEDIUM_T5_CFG, 12, 1, MULTIK_SHAPES[1][1])
    del model3, run3
    torch.cuda.empty_cache()

    stamp("5s, 6s, 5t (SD3)")

    # 5sf. SD3-medium from a single-file checkpoint: seeded bf16 weights on
    # the card with a learned 192x192 pos_embed grid, written in SD3's layout
    # by state_map.sd3_state_from_params, read back by load_sd3_params ----
    cfg3 = sd3.SD3_MEDIUM_CFG
    pe_key = f"{state_map.MMDIT_PREFIX}.pos_embed"
    with tempfile.TemporaryDirectory() as tmp:
        path3 = Path(tmp) / "sd3_medium.safetensors"
        seeded = sd3.StableDiffusion3(cfg3, device=dev, dtype=dtype, seed=31,
                                      learned_pos_embed=True)
        fill_zero_init(seeded.mmdit, 32)
        g3 = torch.Generator(device=dev).manual_seed(33)
        grid = (torch.randn((1, SD3_FILE_GRID ** 2, cfg3.mmdit.dim), generator=g3, device=dev)
                * 0.02).to(dtype)
        state = state_map.sd3_state_from_params(seeded)
        state[pe_key] = grid
        need = sum(v.numel() * v.element_size() for v in state.values())
        free = shutil.disk_usage(tmp).free
        if free < need * 1.2:
            fail(f"{tmp} has {free / 1e9:.1f} GB free, the SD3 file needs {need / 1e9:.1f}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        safetensors_io.save_state_dict(state, path3)
        save_s = time.perf_counter() - t0
        del state
        t0 = time.perf_counter()
        loaded = checkpoints.load_sd3_params(path3, cfg3, device=dev, dtype=dtype)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        size_gb = path3.stat().st_size / 1e9
    # the file is gone here; every tensor it held must have come back
    grid_n = cfg3.mmdit.input_size // cfg3.mmdit.patch_size
    top = (SD3_FILE_GRID - grid_n) // 2
    crop = grid.reshape(SD3_FILE_GRID, SD3_FILE_GRID, -1)[top:top + grid_n, top:top + grid_n]
    mine, theirs = state_map.sd3_state_from_params(seeded), state_map.sd3_state_from_params(loaded)
    mine[pe_key] = crop.reshape(1, grid_n * grid_n, -1)
    differ = [k for k, v in mine.items() if not torch.equal(theirs[k], v)]
    last = f"mmdit.blocks.{cfg3.mmdit.depth - 1}.txt."
    unreachable = [n for n, v in loaded.named_parameters()
                   if n.startswith((last + "proj.", last + "mlp.")) and v.any()]
    n_params = sum(v.numel() for v in seeded.parameters())
    say(f"[ckpt-sd3] SD3-medium single-file checkpoint, bf16 safetensors: {size_gb:.3f} GB, "
        f"{len(mine)} tensors ({n_params / 1e9:.3f} G parameters in the model; pos_embed "
        f"stored as {SD3_FILE_GRID}x{SD3_FILE_GRID}, read as the centre {grid_n}x{grid_n}); "
        f"save {save_s:.2f} s, load_sd3_params {load_s:.2f} s; tensors that differ from the "
        f"seeded ones (the crop against the slice of the stored grid): {len(differ)}; the "
        f"pre-only block's unreachable leaves non-zero: {len(unreachable)}")
    if mine.keys() != theirs.keys() or differ or unreachable:
        fail(f"the SD3 file did not read back bit for bit: {differ[:8]} {unreachable[:4]}")
    del seeded, mine, theirs, grid, crop
    torch.cuda.empty_cache()
    model3, run3, file_launches, file_shapes = sd3_images(
        "main-sd3-file", cfg3, 0, 1, MULTIK_SHAPES[0][1], model3=loaded)
    del model3, run3, loaded
    torch.cuda.empty_cache()

    # [t5-map] T5-XXL's map at full width: written and read back in memory
    t5a = t5_mod.T5Encoder(t5_mod.T5_XXL, device=dev, dtype=dtype)
    init_weights(t5a, seed=34)
    t0 = time.perf_counter()
    t5_state = state_map.t5_to_state(t5a)
    t5b = t5_mod.T5Encoder(t5_mod.T5_XXL, device=dev, dtype=dtype)
    state_map.t5_from_state(t5_state, t5b)
    torch.cuda.synchronize()
    t5_s = time.perf_counter() - t0
    back = dict(t5b.named_parameters())
    differ = [n for n, v in t5a.named_parameters() if not torch.equal(back[n], v)]
    t5_gb = sum(v.numel() * v.element_size() for v in t5_state.values()) / 1e9
    say(f"[t5-map] T5-XXL ({sum(v.numel() for v in t5a.parameters()) / 1e9:.3f} G parameters) "
        f"through t5_to_state / t5_from_state in memory: {len(t5_state)} tensors, {t5_gb:.3f} GB "
        f"in bf16, {t5_s:.2f} s; parameters that differ: {len(differ)}")
    if differ:
        fail(f"the T5-XXL map did not round-trip bit for bit: {differ[:8]}")
    del t5a, t5b, t5_state, back
    torch.cuda.empty_cache()

    # 5sq. the quantized MMDiT through tools/sd3_bench_torch.py's job: dense,
    # int8, int4 in turn (the JAX tool's fill), a warm-up's latents, one image
    sys.path.insert(0, str(ROOT / "tools"))
    import sd3_bench_torch

    sd3_quant, sd3q_secs, sd3q_lat = {}, {}, {}
    want_q3 = {kn: {} for kn in wrappers}
    want_q3.update(flash_packed={MULTIK_SHAPES[0][1]: SD3_STEPS * cfg3.mmdit.depth},
                   flash_bhsd={bhsd_1024: 1})
    for quant in ("none", "int8", "int4"):
        job3 = sd3_bench_torch.build("sd3", quant, steps=SD3_STEPS, device=dev)
        torch.cuda.synchronize()
        held_gb = torch.cuda.memory_allocated() / 1e9
        lat_q = job3.latents()
        if not torch.isfinite(lat_q.float()).all():
            fail(f"[main-sd3-{quant}] latents not finite")
        sd3q_lat[quant] = lat_q.float()
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for i in range(PATH_IMAGES):
            if i == 0:
                reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img_q = job3.image()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if i == 0:
                counted = {kn: dict(w.shapes) for kn, w in wrappers.items()}
                quant_variants = {kn: dict(wrappers[kn].variants)
                                  for kn in ("quant_matmul", "quant_matmul_int4")}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {kn: dict(v) for kn, v in want_q3.items()}
        want_var = {"quant_matmul": {}, "quant_matmul_int4": {}}
        if quant != "none":
            kname, row_key = qformats[quant][1], qformats[quant][3]
            want[kname] = {row_key(*mkn): n for mkn, n in MMDIT_QUANT_SHAPES.items()}
            want_var[kname] = {"wgmma": sum(MMDIT_QUANT_SHAPES.values())}
        n_q = sum(p.numel() for n, p in job3.model.mmdit.named_buffers()
                  if n.endswith(("weight_values", "weight_packed")))
        rel = ((sd3q_lat[quant] - sd3q_lat["none"]).norm() / sd3q_lat["none"].norm()).item()
        say(f"[main-sd3-{quant}] SD3-medium 1024x1024 {SD3_STEPS}-step Euler flow CFG "
            f"{sd3_bench_torch.GUIDANCE} bf16, tools/sd3_bench_torch.py's job (--quant {quant}): "
            f"s/image {[round(x, 4) for x in secs]}; held {held_gb:.2f} GB, peak "
            f"{peak_gb:.2f} GB; quantized weight bytes in the MMDiT {n_q / 1e6:.2f} M; final "
            f"latents vs dense rel {rel:.4e}; launches by shape {counted}; quant launches by "
            f"variant {quant_variants}; card {card}")
        if (counted != want or quant_variants != want_var or img_q.dtype != torch.uint8
                or tuple(img_q.shape) != (1, 1024, 1024, 3)):
            fail(f"[main-sd3-{quant}] launches {counted}, variants {quant_variants} against "
                 f"{want}, {want_var}, or the image {img_q.dtype} {tuple(img_q.shape)}")
        for kn, by_shape in counted.items():
            if set(by_shape) - measured(kn):
                fail(f"[main-sd3-{quant}] {kn}: shapes {by_shape} not all measured in phase 3")
        sd3q_secs[quant] = secs
        if quant != "none":
            sd3_quant[quant] = counted[qformats[quant][1]]
        del job3, lat_q, img_q
        torch.cuda.empty_cache()
    say(f"[main-sd3-quant] s/image over dense's (the better of two each): "
        f"{ {q: round(min(v) / min(sd3q_secs['none']), 4) for q, v in sd3q_secs.items()} }")
    del sd3q_lat

    stamp("5sf, 5sq (SD3 from a file, T5-XXL map, quantized MMDiT)")

    # 5c. the SD2.1-v checkpoint: written, read back --------------------------
    cfg21 = sd.SD21_V
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "sd21v.safetensors"
        model21 = sd.StableDiffusion(cfg21, device=dev, dtype=dtype, seed=15)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoints.save_sd_checkpoint(model21, ckpt, cfg21, dtype=torch.float16)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = checkpoints.load_sd_params(ckpt, cfg21, device=dev, dtype=dtype)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        mine, theirs = dict(model21.named_parameters()), dict(loaded.named_parameters())
        differ = [n for n, v in mine.items()
                  if not torch.equal(theirs[n], v.to(torch.float16).to(dtype))]
        n_params = sum(v.numel() for v in mine.values())
        say(f"[ckpt-sd21] SD2.1-v checkpoint, fp16 safetensors: {ckpt.stat().st_size / 1e9:.3f} "
            f"GB, {len(mine)} tensors, {n_params / 1e9:.3f} G parameters; save_sd_checkpoint "
            f"{save_s:.2f} s, load_sd_params {load_s:.2f} s; parameters that differ from the "
            f"seeded model after the same fp16 round trip: {len(differ)}")
        if mine.keys() != theirs.keys() or differ:
            fail(f"the SD2.1-v checkpoint did not read back bit for bit: {differ[:8]}")
        del model21, loaded, mine, theirs
        torch.cuda.empty_cache()

        # 5v. SD2.1-v at 768x768 through the CLI's code, from that file ------
        sys.path.insert(0, str(ROOT / "examples"))
        import txt2img_torch

        job = txt2img_torch.build(txt2img_torch.parse_args(SD21_ARGV + ["--ckpt", str(ckpt)]))
        lat21 = job.latents()  # warm-up, then the image's stages
        torch.cuda.synchronize()
        if tuple(lat21.shape) != (1, 96, 96, 4) or not torch.isfinite(lat21.float()).all():
            fail(f"SD2.1-v latents {tuple(lat21.shape)} not finite of shape (1, 96, 96, 4)")
        warm21 = job.image()
        torch.cuda.synchronize()
        say(f"[main-sd21] warm-up: latents finite, |lat| max "
            f"{lat21.float().abs().max().item():.3f}; context ids {tuple(job.ids.shape)}")
        held_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for i in range(PATH_IMAGES):
            if i == 0:
                reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img21 = job.image()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if i == 0:
                sd21_launches = {kn: w.launches for kn, w in wrappers.items()}
                sd21_shapes = {kn: dict(w.shapes) for kn, w in wrappers.items()}
                sd21_variants = variants()
                first21 = img21
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if img21.dtype != torch.uint8 or tuple(img21.shape) != (1, 768, 768, 3):
            fail(f"SD2.1-v image {img21.dtype} {tuple(img21.shape)}, want uint8 (1, 768, 768, 3)")
        want = dict.fromkeys(wrappers, 0)
        want.update(flash_packed=400, flash_bhsd=1, geglu=320)
        want_shapes = {kn: {} for kn in wrappers}
        want_shapes.update(
            flash_packed={key: 100 for _, key in SD21_PACKED_SHAPES},
            flash_bhsd={BHSD_SHAPES[2][1]: 1},
            geglu={mkn: n for _, mkn, n in SD21_GEGLU_SHAPES})
        want_variants21 = {"flash_packed": {"wgmma": 400}, "flash_bhsd": {"wgmma_wide": 1},
                           "geglu": {"wgmma": 320}}
        say(f"[main-sd21] launches in one image: {sd21_launches} (want {want}); shapes "
            f"{sd21_shapes}; flash and geglu launches by variant {sd21_variants}")
        if (sd21_launches != want or sd21_shapes != want_shapes
                or sd21_variants != want_variants21):
            fail(f"SD2.1-v: launches {sd21_launches}, shapes {sd21_shapes}, variants "
                 f"{sd21_variants} against {want}, {want_shapes}, {want_variants21}")
        for kn, by_shape in sd21_shapes.items():
            if set(by_shape) - measured(kn):
                fail(f"SD2.1-v {kn}: main-path shapes {by_shape} not all measured in phase 3")
        diff = (first21.int() - warm21.int()).abs().max().item()
        say(f"[main-sd21] SD2.1-v 768x768 {STEPS}-step dpmpp_2m karras CFG {GUIDANCE} rescale "
            f"0.7 bf16 batch 1, from the checkpoint through examples/txt2img_torch.py: s/image "
            f"{[round(x, 4) for x in secs]} mean {sum(secs) / len(secs):.4f}; peak device "
            f"memory {peak_gb:.2f} GB ({held_gb:.2f} GB held before the images); image max "
            f"diff vs warm-up {diff}; card {card}")

        # the other samplers: network calls x 20 flash_packed and 16 geglu
        for sampler, calls in (("euler_ancestral", STEPS), ("heun", 2 * STEPS - 1)):
            other = dataclasses.replace(job, args=argparse.Namespace(
                **dict(vars(job.args), sampler=sampler, schedule="ladder")))
            reset_counts()
            t0 = time.perf_counter()
            lat_o = other.latents()
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            got = {kn: w.launches for kn, w in wrappers.items()}
            want = dict.fromkeys(wrappers, 0)
            want.update(flash_packed=20 * calls, geglu=16 * calls)
            say(f"[main-sd21] {sampler} ladder: {calls} network calls, launches {got} (want "
                f"{want}), latents finite {bool(torch.isfinite(lat_o.float()).all())}, "
                f"|lat| max {lat_o.float().abs().max().item():.3f}, {took:.3f} s for the "
                f"latents")
            if got != want or not torch.isfinite(lat_o.float()).all():
                fail(f"SD2.1-v {sampler}: launches {got} against {want}, or latents not finite")

        # 6v. profile: one more SD2.1-v image ----------------------------------
        prof = profile(job.image)
        say(f"[profile] one SD2.1-v 768x768 image under torch.profiler: {json.dumps(prof)}")
        del job, lat21, warm21, img21, first21, lat_o, other
        torch.cuda.empty_cache()
    # the temporary directory and the checkpoint in it are gone here

    stamp("5c, 5v, 6v (SD2.1-v)")

    # 5n-5p. SD1.5 beyond text to image: ControlNet, DeepCache, FreeU, the
    # hires fix, img2img and inpainting ---------------------------------------
    sd15 = sd.SD15
    full_pass = unet_launches(sd15.unet, 64, 2)  # one SD1.5 UNet call at 512x512, CFG 2
    vae_512, vae_1024 = {(1, 4096, 4096, 512): 1}, {bhsd_1024: 1}

    def want_variants_of(flash, bhsd, geglu):
        """Launches by variant that counts by shape give: each flash_packed
        shape on _plan's variant (d = 160 on wgmma_wide), flash_bhsd on
        wgmma_wide, geglu on wgmma."""
        by = {}
        for (_, _, _, c, h, _), n in flash.items():
            variant = _plan(dtype, c // h)[0]
            by[variant] = by.get(variant, 0) + n
        return {"flash_packed": by,
                "flash_bhsd": {"wgmma_wide": sum(bhsd.values())} if bhsd else {},
                "geglu": {"wgmma": sum(geglu.values())} if geglu else {}}

    @contextlib.contextmanager
    def counting(tag, want, path=None, more=None):
        """The launches of what runs inside, checked exactly against want =
        (flash_packed, flash_bhsd, geglu launches by call shape) and
        ``more`` (a quant wrapper -> launches by call shape, all on its
        wgmma variant), by variant, and every shape measured in phase 3;
        kept for the kernels line under ``path`` (by default the SD1.5 path
        of the tag)."""
        reset_counts()
        yield
        torch.cuda.synchronize()
        counts = {kn: w.launches for kn, w in wrappers.items()}
        counted = {kn: dict(w.shapes) for kn, w in wrappers.items()}
        by_variant = variants()
        by_variant.update((kn, dict(wrappers[kn].variants)) for kn in more or {})
        want_shapes = {kn: {} for kn in wrappers}
        want_shapes.update(flash_packed=want[0], flash_bhsd=want[1], geglu=want[2], **(more or {}))
        want_counts = {kn: sum(c.values()) for kn, c in want_shapes.items()}
        want_by_variant = want_variants_of(*want)
        want_by_variant.update((kn, {"wgmma": sum(c.values())}) for kn, c in (more or {}).items())
        say(f"[{tag}] launches in one image: {counts} (want {want_counts}); shapes {counted}; "
            f"flash and geglu launches by variant {by_variant}")
        if (counts != want_counts or counted != want_shapes or by_variant != want_by_variant
                or set(by_variant["flash_packed"]) - set(WGMMA)):
            fail(f"{tag}: launches {counts}, shapes {counted}, variants {by_variant} against "
                 f"{want_counts}, {want_shapes}, {want_by_variant}")
        for kn, by_shape in counted.items():
            if set(by_shape) - measured(kn):
                fail(f"{tag} {kn}: shapes {by_shape} not all measured in phase 3")
        extra_paths[path or tag.replace("main-", "sd15_").replace("-", "_")] = (counts, counted)

    def images(tag, run, n_images, want, img_shape, what, path=None, more=None):
        """n_images images of run(), the first with its launches counted and
        checked (``counting``); s/image by the host clock after synchronize,
        held and peak device memory. Returns the last image."""
        held_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for i in range(n_images):
            with counting(tag, want, path, more) if i == 0 else contextlib.nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = run()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if img.dtype != torch.uint8 or tuple(img.shape) != img_shape:
            fail(f"{tag}: image {img.dtype} {tuple(img.shape)}, want uint8 {img_shape}")
        say(f"[{tag}] {what} bf16 batch 1: s/image {[round(x, 4) for x in secs]} mean "
            f"{sum(secs) / len(secs):.4f}; peak device memory {peak_gb:.2f} GB ({held_gb:.2f} "
            f"GB held before the images); card {card}")
        return img

    def finite_latents(tag, lat, shape):
        if tuple(lat.shape) != shape or not torch.isfinite(lat.float()).all():
            fail(f"{tag}: latents {tuple(lat.shape)} not finite of shape {shape}")
        say(f"[{tag}] warm-up: latents finite, |lat| max {lat.float().abs().max().item():.3f}")

    with tempfile.TemporaryDirectory() as tmp:
        # 5n. a ControlNet checkpoint (lllyasviel's cldm_v15 control_stage_config:
        # SD1.5's encoder widths, a 3-channel hint), written and read back
        cn_path = Path(tmp) / "control_sd15.safetensors"
        cn_seeded = cn_mod.ControlNet(sd15.unet, device=dev, dtype=dtype, seed=21)
        fill_zero_init(cn_seeded, 22)  # the JAX init's zero convs would add nothing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoints.save_controlnet_checkpoint(cn_seeded, cn_path, dtype=torch.float16)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cn_loaded = checkpoints.load_controlnet_params(cn_path, sd15.unet, device=dev,
                                                       dtype=dtype)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        mine, theirs = dict(cn_seeded.named_parameters()), dict(cn_loaded.named_parameters())
        differ = [n for n, v in mine.items()
                  if not torch.equal(theirs[n], v.to(torch.float16).to(dtype))]
        say(f"[ckpt-cn] SD1.5 ControlNet (control_model.*), fp16 safetensors: "
            f"{cn_path.stat().st_size / 1e9:.3f} GB, {len(mine)} tensors, "
            f"{sum(v.numel() for v in mine.values()) / 1e9:.3f} G parameters; "
            f"save_controlnet_checkpoint {save_s:.2f} s, load_controlnet_params {load_s:.2f} s; "
            f"parameters that differ from the seeded ones after the same fp16 round trip: "
            f"{len(differ)}")
        if mine.keys() != theirs.keys() or differ:
            fail(f"the ControlNet checkpoint did not read back bit for bit: {differ[:8]}")
        del cn_seeded, cn_loaded, mine, theirs

        # 5n. one ControlNet + UNet step at full width, fp32, card vs CPU (32x32
        # latents: the 1024-token level takes flash_packed in both)
        cn_gpu = cn_mod.ControlNet(sd15.unet, device=dev, dtype=torch.float32, seed=23)
        fill_zero_init(cn_gpu, 24)
        u_gpu = unet_mod.UNet(sd15.unet, device=dev, dtype=torch.float32)
        init_weights(u_gpu, seed=25)
        cn_cpu = cn_mod.ControlNet(sd15.unet, device="cpu", dtype=torch.float32, seed=None)
        cn_cpu.load_state_dict(cn_gpu.state_dict())
        u_cpu = unet_mod.UNet(sd15.unet, device="cpu", dtype=torch.float32)
        u_cpu.load_state_dict(u_gpu.state_dict())
        g_cpu = torch.Generator().manual_seed(26)
        x = torch.randn((2, 32, 32, 4), generator=g_cpu)
        ctx = torch.randn((2, 77, 768), generator=g_cpu)
        hint = torch.rand((2, 256, 256, 3), generator=g_cpu)
        t = torch.full((2,), 741.0)
        reset_counts()
        with torch.inference_mode():
            ctrl = cn_mod.apply(cn_gpu, x.to(dev), hint.to(dev), t.to(dev), ctx.to(dev))
            got = unet_mod.apply(u_gpu, x.to(dev), t.to(dev), ctx.to(dev), control=ctrl)
            torch.cuda.synchronize()
            counts = {kn: w.launches for kn, w in wrappers.items()}
            t0 = time.perf_counter()
            ctrl_cpu = cn_mod.apply(cn_cpu, x, hint, t, ctx)
            want = unet_mod.apply(u_cpu, x, t, ctx, control=ctrl_cpu)
            cpu_s = time.perf_counter() - t0
        err = rel_err(got.cpu(), want)
        res_err = max(rel_err(a.cpu(), b)[1] for a, b in zip([*ctrl[0], ctrl[1]],
                                                            [*ctrl_cpu[0], ctrl_cpu[1]]))
        f_unet, g_unet = unet_launches(sd15.unet, 32, 2)
        f_cn, g_cn = unet_launches(sd15.unet, 32, 2, "control")
        expect = dict.fromkeys(wrappers, 0)
        expect.update(flash_packed=sum(f_unet.values()) + sum(f_cn.values()),
                      geglu=sum(g_unet.values()) + sum(g_cn.values()))
        say(f"[unet-cn] SD1.5 ControlNet (zero convs refilled) + UNet fp32 256x256 (2,32,32,4), "
            f"hint (2,256,256,3): card vs CPU max_abs={err[0]:.3e} rel={err[1]:.3e} (tol "
            f"{unet_tol:.0e}), largest residual rel {res_err:.3e}; kernel launches on the card: "
            f"{counts} (want {expect}); CPU forward {cpu_s:.1f} s")
        if not (err[1] <= unet_tol and res_err <= unet_tol and counts == expect):
            fail("the ControlNet step on the card disagrees with the CPU or its launches are "
                 f"not {expect}")
        del cn_gpu, u_gpu, cn_cpu, u_cpu, got, want, ctrl, ctrl_cpu
        torch.cuda.empty_cache()

        # 5n. ControlNet images at 512x512 through the CLI's build() with
        # --control-ckpt; a seeded hint in place of --control-image
        job = txt2img_torch.build(txt2img_torch.parse_args(
            SD15_ARGV + ["--control-ckpt", str(cn_path), "--control-scale", "0.9"]))
        g_hint = torch.Generator(device=dev).manual_seed(27)
        job.control = (job.control[0], torch.rand((1, 512, 512, 3), generator=g_hint,
                                                  device=dev), job.control[2])
        finite_latents("main-cn", job.latents(), (1, 64, 64, 4))
        want = launches_of((STEPS, full_pass), (STEPS, unet_launches(sd15.unet, 64, 2, "control")))
        images("main-cn", job.image, PATH_IMAGES, (want[0], vae_512, want[1]), (1, 512, 512, 3),
               f"SD1.5 + ControlNet 512x512 {STEPS}-step DDIM CFG {GUIDANCE} scale 0.9, through "
               f"examples/txt2img_torch.py --control-ckpt,")
        prof = profile(job.image, host_ops=True)
        say(f"[profile] one SD1.5 + ControlNet image under torch.profiler: {json.dumps(prof)}")

        # [cn-compose] tools/controlnet_compose_bench_torch.py's four modes on
        # this ControlNet with the tool's gates (0.02), checkerboard hint and
        # scale 1.0: the tool's own loop, a warm-up, then one counted, timed
        # image each
        import controlnet_compose_bench_torch as compose

        control = (compose.open_gates(job.control[0]), compose.checkerboard(sd15, dev), 1.0)
        cn2 = unet_launches(sd15.unet, 64, 2, "control")
        b1, b1_cn = unet_launches(sd15.unet, 64, 1), unet_launches(sd15.unet, 64, 1, "control")
        half = sum(n % 2 == 0 for n in range(STEPS))  # full passes / uncond calls at k = 2
        compose_want = {
            "exact+control": launches_of((STEPS, full_pass), (STEPS, cn2)),
            "cached_cfg u=2": launches_of((STEPS + half, b1), (STEPS + half, b1_cn)),
            "deepcache k=2": launches_of((half, full_pass), (half, cn2),
                                         (STEPS - half, unet_launches(sd15.unet, 64, 2,
                                                                      "shallow", 3))),
            "dc k=2 + u=2": launches_of((2 * half, b1), (2 * half, b1_cn),
                                        (STEPS - half, unet_launches(sd15.unet, 64, 1,
                                                                     "shallow", 3)))}
        rows = compose.run_modes(
            job.model, control, job.ids, job.uids, job.latent, STEPS, repeats=1,
            counted=lambda mode: counting(
                "cn-compose", (compose_want[mode][0], vae_512, compose_want[mode][1]),
                path="cn_compose_" + re.sub(r"\W+", "_", mode).strip("_")),
            report=lambda line: say(f"[cn-compose] SD1.5 + ControlNet 512x512 {STEPS}-step "
                                    f"DDIM CFG {compose.GUIDANCE}: {line}; card {card}"))
        for row in rows:
            img = row["image"]
            if img.dtype.name != "uint8" or img.shape != (1, 512, 512, 3) or not (
                    row["psnr"] is None or row["psnr"] > 0):
                fail(f"cn-compose {row['mode']}: image {img.dtype} {img.shape}, PSNR "
                     f"{row['psnr']}")
        del rows

        stamp("5n (ControlNet, cn-compose)")

        # 5d. DeepCache (interval 3, split 3), with cached CFG, and FreeU
        plain_job = dataclasses.replace(job, control=None)
        del job
        torch.cuda.empty_cache()

        def with_args(**kw):
            return dataclasses.replace(plain_job, args=argparse.Namespace(
                **dict(vars(plain_job.args), **kw)))

        calls = range(STEPS)  # DDIM: one network call a step, the counter n
        n_full = sum(n % 3 == 0 for n in calls)
        shallow = unet_launches(sd15.unet, 64, 2, "shallow", 3)
        b1_full = unet_launches(sd15.unet, 64, 1)
        b1_shallow = unet_launches(sd15.unet, 64, 1, "shallow", 3)
        n_uncond = sum(n % 2 == 0 for n in calls)
        for tag, kw, want, what in (
                ("main-deepcache", dict(deepcache_interval=3, deepcache_split=3),
                 launches_of((n_full, full_pass), (STEPS - n_full, shallow)),
                 f"DeepCache interval 3 split 3 ({n_full} full UNet calls, "
                 f"{STEPS - n_full} shallow)"),
                ("main-deepcache-cfg", dict(deepcache_interval=3, deepcache_split=3,
                                            uncond_interval=2),
                 launches_of((n_full, b1_full), (STEPS - n_full, b1_shallow),
                             (n_uncond, b1_full)),
                 f"DeepCache interval 3 split 3 on the cond branch, cached CFG interval 2 "
                 f"({n_uncond} uncond calls)"),
                ("main-freeu", dict(freeu=(1.5, 1.6, 0.9, 0.2)), launches_of((STEPS, full_pass)),
                 "FreeU (1.5, 1.6, 0.9, 0.2)")):
            other = with_args(**kw)
            finite_latents(tag, other.latents(), (1, 64, 64, 4))
            images(tag, other.image, PATH_IMAGES, (want[0], vae_512, want[1]), (1, 512, 512, 3),
                   f"SD1.5 512x512 {STEPS}-step DDIM CFG {GUIDANCE}, {what},")

        stamp("5d (DeepCache, FreeU)")

        # 5h. the hires fix: 512x512 base, x2 latent, 12 tail steps at 1024x1024
        hires = with_args(hires_scale=2, hires_strength=0.6)
        tail = STEPS - sd.hires_tail_start(STEPS, 0.6)
        warm = hires.image()
        torch.cuda.synchronize()
        want = launches_of((STEPS, full_pass), (tail, unet_launches(sd15.unet, 128, 2)))
        images("main-hires", hires.image, PATH_IMAGES, (want[0], vae_1024, want[1]),
               (1, 1024, 1024, 3), f"SD1.5 hires fix: 512x512 {STEPS}-step DDIM CFG "
               f"{GUIDANCE}, latent x2, strength 0.6 ({tail} tail steps at 1024x1024),")
        prof = profile(hires.image)
        say(f"[profile] one SD1.5 hires-fix 1024x1024 image under torch.profiler: "
            f"{json.dumps(prof)}")
        del warm

        stamp("5h (hires fix)")

        # 5i. img2img at 512x512 (15 of 20 steps) and inpainting (the 9-channel
        # UNet of runwayml's v1-inpainting-inference.yaml) on a seeded image
        g_src = torch.Generator(device=dev).manual_seed(31)
        src = torch.randint(0, 256, (1, 512, 512, 3), generator=g_src, device=dev,
                            dtype=torch.uint8)
        model15, ids15, uids15 = plain_job.model, plain_job.ids, plain_job.uids

        def run_img2img():
            return sd.img2img(model15, src, ids15, uids15,
                              torch.Generator(device=dev).manual_seed(32), GUIDANCE,
                              num_steps=STEPS, start_step=15)

        run_img2img()
        want = launches_of((15, full_pass))
        images("main-img2img", run_img2img, PATH_IMAGES,
               (want[0], {(1, 4096, 4096, 512): 2}, want[1]), (1, 512, 512, 3),
               f"SD1.5 img2img 512x512, 15 of {STEPS} DDIM steps, CFG {GUIDANCE}, VAE encode "
               "and decode,")
        del plain_job, hires, other, model15
        torch.cuda.empty_cache()
        inp_cfg = dataclasses.replace(sd15, unet=unet_mod.SD15_INPAINT_CONFIG)
        model_in = sd.StableDiffusion(inp_cfg, device=dev, dtype=dtype, seed=33)
        mask = torch.zeros((1, 512, 512, 1), device=dev)
        mask[:, :, 256:] = 1.0
        lat_in = sd.initial_latent(34, 1, inp_cfg, device=dev, dtype=dtype)

        def run_inpaint():
            return sd.inpaint(model_in, src, mask, ids15, uids15, lat_in, GUIDANCE,
                              num_steps=STEPS)

        run_inpaint()
        want = launches_of((STEPS, full_pass))
        img = images("main-inpaint", run_inpaint, PATH_IMAGES,
                     (want[0], {(1, 4096, 4096, 512): 2}, want[1]), (1, 512, 512, 3),
                     f"SD1.5 inpainting (9-channel UNet) 512x512, right half masked, {STEPS}-step "
                     f"DDIM CFG {GUIDANCE},")
        kept = (mask <= 0.5).expand_as(img)
        same = bool(torch.equal(img[kept], src[kept]))
        repainted = (img[~kept].int() - src[~kept].int()).abs().float().mean().item()
        say(f"[main-inpaint] pixels kept (mask <= 0.5) equal to the source bit for bit: {same}; "
            f"repainted half's mean |image - source| {repainted:.2f}")
        if not same:
            fail("inpainting changed pixels outside the mask")
        del model_in, img, src
        torch.cuda.empty_cache()
    # the ControlNet checkpoint is gone here

    stamp("5i (img2img, inpainting)")

    # [ckpt-drill] tools/ckpt_drill_torch.py: the full-geometry SD1.5 state
    # (1.066 B parameters, fp16) as .safetensors and torch-zip .ckpt, each
    # read back through load_sd_params bit for bit and run through the CLI
    # in a child (load seconds, peak host RSS); the files deleted
    t0 = time.perf_counter()
    drill = subprocess.run([sys.executable, str(ROOT / "tools" / "ckpt_drill_torch.py"),
                            "--steps", str(DRILL_STEPS)], capture_output=True, text=True,
                           cwd=ROOT, timeout=900)
    for line in drill.stdout.splitlines():
        say(f"[ckpt-drill] {line}")
    summary = [json.loads(line[len("drill: "):]) for line in drill.stdout.splitlines()
               if line.startswith("drill: ")]
    if drill.returncode != 0 or not summary or sorted(summary[0]) != [".ckpt", ".safetensors"]:
        fail(f"[ckpt-drill] exit {drill.returncode}: {drill.stderr[-2000:]}")
    say(f"[ckpt-drill] both containers' parameters equal the written state after fp16 -> "
        f"bf16, the CLI ran on each ({DRILL_STEPS} steps): "
        f"{all(r['params_equal'] and r['cli']['ok'] for r in summary[0].values())}; "
        f"{time.perf_counter() - t0:.1f} s wall; card {card}")
    if not all(r["params_equal"] and r["cli"]["ok"] for r in summary[0].values()):
        fail("[ckpt-drill] a container's parameters differ or its CLI run failed")
    stamp("ckpt-drill")

    # 5e. serving: the continuous-batching engine over 4 slots ------------------
    import numpy as np

    from tinyfusers_tpu_torch.kernels import counters
    from tinyfusers_tpu_torch.native import get_lib
    from tinyfusers_tpu_torch.serve import Engine, Router
    from tinyfusers_tpu_torch.serve.engine import _NativeSchedulerCore, _PySchedulerCore
    from tinyfusers_tpu_torch.utils import flops as flops_mod
    from tinyfusers_tpu_torch.utils.profiling import (
        StepMetrics, device_memory_stats, device_time_from_trace, trace)

    if get_lib() is None:
        fail("serve: libtfnative could not be built from native/*.cpp with g++")
    serve_model = sd.StableDiffusion(sd15, device=dev, dtype=dtype, seed=0)
    serve_ids = np.full((77,), 49407, np.int64)  # as benchmarks/serve_quant_bench.py
    serve_ids[0] = 49406
    eng = Engine(serve_model, num_slots=SERVE_SLOTS)
    if not isinstance(eng.core, _NativeSchedulerCore):
        fail(f"serve: the engine runs the {type(eng.core).__name__}, not the native core")
    eng.submit(eng.make_request(serve_ids, serve_ids, num_steps=4, seed=100))  # warm-up
    warm = eng.run_until_idle()
    if len(warm) != 1 or warm[0].image.shape != (512, 512, 3) or warm[0].image.dtype != np.uint8:
        fail(f"serve: warm-up gave {[(r.image.shape, r.image.dtype) for r in warm]}")

    # the ticks that run the UNet, by the scheduler's own rules
    sim, active_ticks = _PySchedulerCore(SERVE_SLOTS), 0
    for i in range(SERVE_REQUESTS + 10 ** 4):
        if i < SERVE_REQUESTS:
            sim.submit(i, SERVE_MIX[i % 3])
        elif not (sim.active() or sim.pending()):
            break
        sim.assign()
        active_ticks += sim.active() > 0
        sim.tick()
    reqs = [eng.make_request(serve_ids, serve_ids, num_steps=SERVE_MIX[i % 3], seed=i)
            for i in range(SERVE_REQUESTS)]
    submitted, served, latency = {}, {}, StepMetrics()

    def collect(batch):
        now = time.perf_counter()
        for r in batch:
            served[r.request_id] = r.image
            latency.record(now - submitted[r.request_id])

    eng.stats.update(submitted=0, completed=0, first_submit_t=None, first_result_s=None,
                     graph_steps=0, eager_steps=0)
    torch.cuda.synchronize()
    held = device_memory_stats()["bytes_in_use"]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    ticks = 0
    for r in reqs:  # one submission a tick: requests join mid-flight
        submitted[r.request_id] = time.perf_counter()
        eng.submit(r)
        collect(eng.step())
        ticks += 1
    while eng.core.active() or eng.core.pending():
        collect(eng.step())
        ticks += 1
    collect(eng.flush())
    wall = time.perf_counter() - t0
    counts = {kn: w.launches for kn, w in wrappers.items()}
    counted = {kn: dict(w.shapes) for kn, w in wrappers.items()}
    by_variant = variants()
    mem = device_memory_stats()
    bad = [rid for rid, img in served.items() if img.shape != (512, 512, 3) or img.dtype != np.uint8]
    if sorted(served) != sorted(r.request_id for r in reqs) or bad:
        fail(f"serve: results {sorted(served)} (bad {bad}) for requests "
             f"{[r.request_id for r in reqs]}")
    per_tick = unet_launches(sd15.unet, 64, 2 * SERVE_SLOTS)  # one UNet call on 2S rows
    want_flash, want_geglu = launches_of((active_ticks, per_tick))
    want_bhsd = {key: SERVE_REQUESTS for key in vae_512}
    want_shapes = {kn: {} for kn in wrappers}
    want_shapes.update(flash_packed=want_flash, flash_bhsd=want_bhsd, geglu=want_geglu)
    want_counts = {kn: sum(c.values()) for kn, c in want_shapes.items()}
    want_by_variant = want_variants_of(want_flash, want_bhsd, want_geglu)
    captured = {kn: dict(c[1]) for kn, w in wrappers.items()
                for f, c in zip(counters.COUNTED, eng._graph_counts) if f is w}
    want_captured = {kn: {} for kn in wrappers}
    want_captured.update(flash_packed=per_tick[0], geglu=per_tick[1])
    say(f"[serve] launches over {SERVE_REQUESTS} requests, {active_ticks} ticks with an active "
        f"slot: {counts} (want {want_counts}: 20 flash_packed and 16 geglu a tick, 1 "
        f"flash_bhsd a request); shapes {counted}; by variant {by_variant}. flash_bhsd is "
        f"counted at its calls (the decodes run eagerly); flash_packed and geglu are the "
        f"calls the engine's CUDA graph captured, {captured} (want one UNet pass, "
        f"{want_captured}), times its {eng.stats['graph_steps']} replays (eager slot steps "
        f"{eng.stats['eager_steps']}; want {active_ticks}, 0); the replayed kernels are "
        f"counted by name in the profiled ticks below")
    if captured != want_captured:
        fail(f"serve: the graph captured {captured}, not one UNet pass {want_captured}")
    if (eng.stats["graph_steps"], eng.stats["eager_steps"]) != (active_ticks, 0):
        fail(f"serve: {eng.stats['graph_steps']} graph and {eng.stats['eager_steps']} eager "
             f"slot steps for {active_ticks} ticks with an active slot")
    if (counts != want_counts or counted != want_shapes or by_variant != want_by_variant
            or set(by_variant["flash_packed"]) != {"wgmma"}
            or set(want_flash) != {key for _, key in SERVE_PACKED_SHAPES}):
        fail(f"serve: launches {counts}, shapes {counted}, variants {by_variant} against "
             f"{want_counts}, {want_shapes}, {want_by_variant}")
    for kn, by_shape in counted.items():
        if set(by_shape) - measured(kn):
            fail(f"serve {kn}: shapes {by_shape} not all measured in phase 3")
    extra_paths["serve"] = (counts, counted)
    lat_s = latency.summary()
    model_flops = (flops_mod.unet_fwd_flops(sd15.unet, 64, 64, 2 * SERVE_SLOTS) * active_ticks
                   + flops_mod.vae_decode_flops(sd15.vae, 64, 64, 1) * SERVE_REQUESTS)
    say(f"[serve] SD1.5 512x512 bf16, {SERVE_SLOTS} slots (native scheduler core), CFG "
        f"{GUIDANCE}, {SERVE_REQUESTS} requests of {SERVE_MIX} DDIM steps in turn, one submitted "
        f"a tick: {SERVE_REQUESTS / wall:.4f} images/s, wall {wall:.3f} s, {ticks} ticks "
        f"({active_ticks} with an active slot, {wall / ticks * 1e3:.1f} ms a tick); submit -> "
        f"result p50 {lat_s['p50_s']:.3f} s, p95 {lat_s['p95_s']:.3f} s, mean "
        f"{lat_s['mean_s']:.3f} s; first result {eng.stats['first_result_s']:.3f} s after the "
        f"first submit; held {held / 1e9:.2f} GB, peak {mem['peak_bytes_in_use'] / 1e9:.2f} GB; "
        f"model {model_flops / 1e12:.2f} TFLOP (UNet at batch {2 * SERVE_SLOTS} x "
        f"{active_ticks} + {SERVE_REQUESTS} VAE decodes): {model_flops / wall / 1e12:.1f} "
        f"TFLOP/s, {model_flops / wall / flops_mod.H100_PEAK_BF16:.3f} of the bf16 peak; "
        f"card {card}")
    apart = sorted((k[0], k[1]) for k, v in eng._rows.apart.items() if v)
    say(f"[serve] conv call shapes (x NHWC, w HWIO) the engine runs one row at a time, their "
        f"rows rounding by batch position under cuDNN: {len(apart)} of {len(eng._rows.apart)}: "
        f"{apart}")

    # the device's busy share over a profiled window of 4 ticks, all slots busy
    for i in range(SERVE_SLOTS):
        eng.submit(eng.make_request(serve_ids, serve_ids, num_steps=8, seed=30 + i))
    eng.step()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(4):
                eng.step()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        busy = device_time_from_trace(tmp)
    eng.run_until_idle()
    if busy is None:
        fail("serve: the profiled window holds no device kernel")
    say(f"[serve] 4 ticks of {SERVE_SLOTS} busy slots under torch.profiler: {window:.3f} s, "
        f"device busy {busy:.3f} s (the union of the kernels' intervals), busy share "
        f"{busy / window:.3f}; card {card}")
    replays, want_replay, launched = replays_by_name(eng, serve_ids, 4, 50)
    say(f"[serve] 4 replayed ticks of {SERVE_SLOTS} busy slots under torch.profiler, after one "
        f"that lets it settle: each replay's kernels by name {replays} (want {want_replay}: 20 "
        f"flash_packed and 16 geglu), graph launches {launched} (want 5)")
    if (replays != [want_replay] * 4 or want_replay != {"flash_fwd": 20, "geglu_ff": 16}
            or launched != 5):
        fail(f"serve: the replayed ticks ran {replays} in {launched} graph launches, not 4 x "
             f"{want_replay} in 5")

    # [serve-join] the request with seed 6 joined a busy engine: alone, the same bits
    join = reqs[6]
    eng.submit(eng.make_request(serve_ids, serve_ids, num_steps=join.num_steps, seed=join.seed))
    solo = eng.run_until_idle()
    diff = np.abs(solo[0].image.astype(np.int16) - served[join.request_id].astype(np.int16))
    say(f"[serve-join] request seed {join.seed} ({join.num_steps} steps), joined mid-flight "
        f"into {SERVE_SLOTS} busy slots against alone in the idle engine: {int((diff > 0).sum())} "
        f"of {diff.size} uint8 values differ, max {int(diff.max())}")
    if diff.any():
        fail("serve-join: a request's image depends on the other requests in the batch")

    # [serve-sync] every tick of a short run, admissions (and encodes staged
    # inside the tick) included, without a synchronising call
    for i in range(2 * SERVE_SLOTS + 2):  # past the stage window: the tick stages encodes
        eng.submit(eng.make_request(serve_ids, serve_ids, num_steps=2, seed=40 + i))
    torch.cuda.synchronize()
    n_sync, done = 0, []
    torch.cuda.set_sync_debug_mode("error")
    try:
        while eng.core.active() or eng.core.pending():
            done += eng.step()
            n_sync += 1
    except RuntimeError as e:
        fail(f"serve-sync: tick {n_sync} synchronised with the device: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    done += eng.flush()
    # the embedding's NaN fill as it was (a Python scalar made a device tensor)
    torch.cuda.set_sync_debug_mode("error")
    try:
        serve_model.unet.out_conv.weight.new_tensor(float("nan"))
        scalar_fill_syncs = False
    except RuntimeError:
        scalar_fill_syncs = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    say(f"[serve-sync] {n_sync} ticks ({2 * SERVE_SLOTS + 2} requests, the first tick admitting "
        f"{SERVE_SLOTS} and staging 2 encodes) under torch.cuda.set_sync_debug_mode('error'): "
        f"no synchronising call; {len(done)} images; the embedding's former NaN fill "
        f"(rows.new_tensor(nan) on the card) raises under the same mode: {scalar_fill_syncs}")
    if len(done) != 2 * SERVE_SLOTS + 2:
        fail(f"serve-sync: {len(done)} images for {2 * SERVE_SLOTS + 2} requests")

    # [serve-router] the 4-slot engine and a 1-slot one (batch 2: the main
    # path's shapes) behind a Router; the 4-slot engine's first tick fails
    eng1 = Engine(serve_model, num_slots=1)
    router = Router({"s4": eng, "s1": eng1}, max_retries=1)
    real_step, ptr = eng.step, eng.latents.data_ptr()
    injected = []

    def flaky_step():
        if not injected:
            injected.append(True)
            raise RuntimeError("injected device failure")
        return real_step()

    eng.step = flaky_step
    rids = [router.submit("s4" if i % 2 == 0 else "s1", serve_ids, serve_ids, num_steps=3,
                          seed=60 + i) for i in range(4)]
    routed = router.run_until_idle()
    del eng.step
    health = router.health()
    say(f"[serve-router] {len(routed)} of {len(rids)} requests completed after one injected "
        f"failure; health {health}; the same engine and buffers reused: "
        f"{router.engines['s4'] is eng and eng.latents.data_ptr() == ptr}")
    if (sorted(r.request_id for r in routed) != sorted(rids) or health["s4"]["failures"] != 1
            or health["s1"]["failures"] != 0 or router.engines["s4"] is not eng
            or eng.latents.data_ptr() != ptr):
        fail("serve-router: a request was lost, the failure was not counted or the engine "
             "was replaced")
    # the bound step and the wrapper around it hold the engine and its model
    del serve_model, eng, eng1, router, warm, served, solo, real_step, flaky_step
    torch.cuda.empty_cache()

    stamp("5e (serving)")

    # 4x. the SDXL UNet: full width, fp32, with a random ADM vector, card vs
    # CPU; a 64x64 latent at batch 1, so that its 32x32 level (1024 tokens,
    # 10 heads of 64) takes flash_packed and its 16x16 level the math route
    ucfg_xl = sdxl.SDXL_BASE.unet
    uxl_gpu = unet_mod.UNet(ucfg_xl, device=dev, dtype=torch.float32)
    init_weights(uxl_gpu, seed=41)
    uxl_cpu = unet_mod.UNet(ucfg_xl, device="cpu", dtype=torch.float32)
    uxl_cpu.load_state_dict(uxl_gpu.state_dict())
    g_cpu = torch.Generator().manual_seed(42)
    x = torch.randn((1, 64, 64, 4), generator=g_cpu)
    ctx = torch.randn((1, 77, ucfg_xl.context_dim), generator=g_cpu)
    adm = torch.randn((1, ucfg_xl.adm_in_channels), generator=g_cpu)
    t = torch.full((1,), 901.0)
    reset_counts()
    with torch.inference_mode():
        got = unet_mod.apply(uxl_gpu, x.to(dev), t.to(dev), ctx.to(dev), adm_cond=adm.to(dev))
        torch.cuda.synchronize()
        counts = {kn: w.launches for kn, w in wrappers.items()}
        xl_counted = {kn: dict(wrappers[kn].shapes) for kn in ("flash_packed", "geglu")}
        t0 = time.perf_counter()
        want = unet_mod.apply(uxl_cpu, x, t, ctx, adm_cond=adm)
        cpu_s = time.perf_counter() - t0
    err = rel_err(got.cpu(), want)
    f_xl, g_xl = unet_launches(ucfg_xl, 64, 1)
    expect = dict.fromkeys(wrappers, 0)
    expect.update(flash_packed=sum(f_xl.values()), geglu=sum(g_xl.values()))
    say(f"[unet-sdxl] SDXL UNet (ADM 2816, context 2048, 64-wide heads) fp32 512x512 "
        f"(1,64,64,4): card vs CPU max_abs={err[0]:.3e} rel={err[1]:.3e} (tol "
        f"{unet_tol:.0e}); kernel launches on the card: {counts} (want {expect}), shapes "
        f"{xl_counted}; CPU forward {cpu_s:.1f} s")
    if not (err[1] <= unet_tol and counts == expect
            and xl_counted == {"flash_packed": f_xl, "geglu": g_xl}):
        fail(f"SDXL UNet forward on the card disagrees with the CPU or its launches are not "
             f"{expect} at {f_xl}, {g_xl}")
    del uxl_gpu, uxl_cpu, got, want
    torch.cuda.empty_cache()

    stamp("4x (SDXL UNet, card vs CPU)")

    # 5x. SDXL-base at 1024x1024 from a checkpoint through the CLI ---------------
    xl_cfg = sdxl.SDXL_BASE
    xl_pass = unet_launches(xl_cfg.unet, 128, 2)  # one UNet call at 1024x1024, CFG 2
    want_xl = launches_of((STEPS, xl_pass))
    # the counts of one image, as they are known for SDXL-base: 70 transformer
    # blocks a call (10 at 64x64, 60 at 32x32), 20 calls
    if ({key: want_xl[0].get(key) for _, key in XL_PACKED_SHAPES}
            != dict(zip((key for _, key in XL_PACKED_SHAPES), (200, 200, 1200, 1200)))
            or want_xl[1] != {(8192, 2560, 640): 200, (2048, 5120, 1280): 1200}):
        fail(f"SDXL launches from build_plan {want_xl} are not SDXL-base's")
    xl_tmp = tempfile.TemporaryDirectory()  # kept for the quantized images
    tmp = xl_tmp.name
    xl_path = Path(tmp) / "sdxl_base.safetensors"
    t0 = time.perf_counter()
    seeded = sdxl.StableDiffusionXL(xl_cfg, device=dev, dtype=dtype, seed=43)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    need = sum(p.numel() * p.element_size() for p in seeded.parameters())
    free = shutil.disk_usage(tmp).free
    say(f"[ckpt-sdxl] SDXL-base seeded on the card in {init_s:.2f} s: "
        f"{sum(p.numel() for p in seeded.parameters()) / 1e9:.3f} G parameters, "
        f"{need / 1e9:.3f} GB in bf16; {free / 1e9:.1f} GB free in {tmp}")
    if free < need * 1.2:
        fail(f"{tmp} has {free / 1e9:.1f} GB free, the SDXL file needs {need / 1e9:.1f}")
    t0 = time.perf_counter()
    checkpoints.save_sdxl_checkpoint(seeded, xl_path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    job = txt2img_torch.build(txt2img_torch.parse_args(
        SDXL_ARGV + ["--ckpt", str(xl_path)]))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    mine, theirs = dict(seeded.named_parameters()), dict(job.model.named_parameters())
    differ = [n for n, v in mine.items() if not torch.equal(theirs[n], v)]
    say(f"[ckpt-sdxl] SDXL-base checkpoint, bf16 safetensors: "
        f"{xl_path.stat().st_size / 1e9:.3f} GB, {len(mine)} tensors; "
        f"save_sdxl_checkpoint {save_s:.2f} s, the CLI's build() with --ckpt (load_sdxl_params "
        f"and the tokenizer) {load_s:.2f} s; parameters that differ from the seeded "
        f"model: {len(differ)}")
    if mine.keys() != theirs.keys() or differ:
        fail(f"the SDXL checkpoint did not read back bit for bit: {differ[:8]}")
    del seeded, mine, theirs
    torch.cuda.empty_cache()
    finite_latents("main-sdxl", job.latents(), (1, 128, 128, 4))
    warm_xl = job.image()
    torch.cuda.synchronize()
    images("main-sdxl", job.image, PATH_IMAGES, (want_xl[0], vae_1024, want_xl[1]),
           (1, 1024, 1024, 3),
           f"SDXL-base 1024x1024 {STEPS}-step DDIM CFG {GUIDANCE}, from the checkpoint through "
           f"examples/txt2img_torch.py --preset sdxl --ckpt,", path="sdxl")

    # 6x. profile: one more SDXL image -------------------------------------------
    prof = profile(job.image)
    say(f"[profile] one SDXL-base 1024x1024 image under torch.profiler: {json.dumps(prof)}")
    del job, warm_xl
    torch.cuda.empty_cache()

    # 5xq. SDXL-base with its UNet quantized: the CLI's job from the same file
    # with --quant int8 / fp8 / int4, one image each
    for qname in ("int8", "fp8", "int4"):
        kname, row_key = qformats[qname][1], qformats[qname][3]
        t0 = time.perf_counter()
        job = txt2img_torch.build(txt2img_torch.parse_args(
            SDXL_ARGV + ["--ckpt", str(xl_path), "--quant", qname]))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        finite_latents(f"main-sdxl-{qname}", job.latents(), (1, 128, 128, 4))
        images(f"main-sdxl-{qname}", job.image, 1, (want_xl[0], vae_1024, {}),
               (1, 1024, 1024, 3),
               f"SDXL-base 1024x1024 {STEPS}-step DDIM CFG {GUIDANCE}, UNet {qname} (the CLI's "
               f"build() --preset sdxl --ckpt --quant {qname}: {build_s:.2f} s),",
               path=f"sdxl_{qname}", more={kname: {row_key(*mkn): n
                                                    for mkn, n in sdxl_quant.items()}})
        del job
        torch.cuda.empty_cache()
    xl_tmp.cleanup()  # the checkpoint is gone here

    stamp("5x, 6x, 5xq (SDXL dense and quantized)")

    # 5qe. tools/quant_eval_torch.py at --preset sd15 (seeded bf16 weights on
    # the card), each format: its eps errors and image changes ---------------
    import quant_eval_torch

    for qname in ("int8", "fp8", "int4"):
        t0 = time.perf_counter()
        out = quant_eval_torch.main(["--preset", "sd15", "--quant", qname])
        took = time.perf_counter() - t0
        eps = out["eps_rel"]
        say(f"[quant-eval] tools/quant_eval_torch.py --preset sd15 --quant {qname} "
            f"(--steps 20): mean|d eps|/mean|eps| "
            f"{ {t: round(v, 5) for t, v in eps.items()} }, image PSNR {out['psnr']:.2f} dB, "
            f"max |d pixel| {out['max_pixel_delta']}, changed pixels "
            f"{out['changed'] * 100:.2f}%; {took:.1f} s; card {card}")
        if not (all(0 < v < float("inf") for v in eps.values())
                and out["images"][0].shape == (1, 512, 512, 3)):
            fail(f"[quant-eval] {qname}: eps errors {eps} or images not of (1, 512, 512, 3)")
        del out
        torch.cuda.empty_cache()

    stamp("5qe (quant_eval)")

    # 5ae. tools/accuracy_eval_torch.py at --preset sd15: bf16 and each
    # approximation, scored by the seeded ViT-L/14 scorer; the launches of
    # each variant's images counted -------------------------------------------
    import accuracy_eval_torch

    acc_args = accuracy_eval_torch.parse_args(
        ["--preset", "sd15", "--prompts", str(ACC_PROMPTS), "--variants", ",".join(ACC_VARIANTS)])
    acc_job = accuracy_eval_torch.build(acc_args)
    runs = {}  # path -> (launches by wrapper, by wrapper and shape, by variant)

    @contextlib.contextmanager
    def counted_run(path):
        """The launches of what runs inside, set to 0 just before it and
        read just after, kept under ``path``."""
        reset_counts()
        yield
        torch.cuda.synchronize()
        runs[path] = ({kn: w.launches for kn, w in wrappers.items()},
                      {kn: dict(w.shapes) for kn, w in wrappers.items()},
                      {kn: dict(w.variants) for kn, w in wrappers.items()})

    t0 = time.perf_counter()
    acc_report, acc_images = accuracy_eval_torch.run(
        acc_job, around=lambda name: counted_run(f"accuracy_{name}"))
    acc_s = time.perf_counter() - t0
    accuracy_eval_torch.print_report(acc_report)
    b2_full, b1_full = unet_launches(sd15.unet, 64, 2), unet_launches(sd15.unet, 64, 1)
    n_cached = sum(n % 3 == 0 for n in range(STEPS))  # uncond calls, interval 3; full passes
    shallow3 = unet_launches(sd15.unet, 64, 2, "shallow", 3)
    acc_want = {  # per image: (flash_packed, geglu) by shape, quant by shape
        "fp16": (launches_of((STEPS, b2_full)), {}),
        "cached_cfg": (launches_of((STEPS + n_cached, b1_full)), {}),
        "deepcache": (launches_of((n_cached, b2_full), (STEPS - n_cached, shallow3)), {})}
    for qname in ("int8", "fp8", "int4"):
        acc_want[qname] = ((launches_of((STEPS, b2_full))[0], {}),
                           {qformats[qname][1]: {qformats[qname][3](*mkn): n
                                                 for mkn, n in QUANT_SHAPES.items()}})
    for vname, imgs in acc_images.items():
        (flash_w, geglu_w), quant_w = acc_want[vname]
        want_shapes = {kn: {} for kn in wrappers}
        want_shapes.update(flash_packed={k: ACC_PROMPTS * n for k, n in flash_w.items()},
                           flash_bhsd={k: ACC_PROMPTS * n for k, n in vae_512.items()},
                           geglu={k: ACC_PROMPTS * n for k, n in geglu_w.items()},
                           **{kn: {k: ACC_PROMPTS * n for k, n in c.items()}
                              for kn, c in quant_w.items()})
        counts, counted, by_variant = runs[f"accuracy_{vname}"]
        want_by_variant = want_variants_of(want_shapes["flash_packed"], want_shapes["flash_bhsd"],
                                           want_shapes["geglu"])
        want_by_variant.update(quant_matmul={}, quant_matmul_int4={})
        want_by_variant.update((kn, {"wgmma": sum(want_shapes[kn].values())}) for kn in quant_w)
        scores = cs_mod.clip_score(acc_job.scorer, imgs, acc_job.sids)
        say(f"[accuracy-{vname}] launches over {ACC_PROMPTS} images: {counts}; by variant "
            f"{by_variant}; CLIP scores {[round(float(x), 4) for x in scores]}")
        if (counted != want_shapes or by_variant != want_by_variant
                or imgs.shape != (ACC_PROMPTS, 512, 512, 3) or imgs.dtype.name != "uint8"
                or not all(-100.0 <= float(x) <= 100.0 for x in scores)):
            fail(f"[accuracy-{vname}] launches {counted} / {by_variant} against {want_shapes} / "
                 f"{want_by_variant}, images {imgs.shape} {imgs.dtype} or scores {scores}")
        for kn, by_shape in counted.items():
            if set(by_shape) - measured(kn):
                fail(f"[accuracy-{vname}] {kn}: shapes {by_shape} not all measured in phase 3")
        extra_paths[f"accuracy_{vname}"] = (counts, counted)
    for row in acc_report["rows"]:
        ok = all(math.isfinite(row[k]) for k in ("clip_score_mean", "clip_score_std"))
        if row["variant"] != "fp16":
            ok = ok and row["fid_vs_fp16"] >= 0.0 and row["psnr_vs_fp16_db"] > 5.0
        if not ok:
            fail(f"[accuracy] row {row}")
    say(f"[accuracy] tools/accuracy_eval_torch.py --preset sd15 --prompts {ACC_PROMPTS} "
        f"--variants {','.join(ACC_VARIANTS)} (seeded SD1.5 bf16 and ViT-L/14 scorer, 512x512 "
        f"{STEPS}-step DDIM CFG {GUIDANCE}): {json.dumps(acc_report['rows'])}; {acc_s:.1f} s "
        f"in all; card {card}")
    del acc_job, acc_images
    torch.cuda.empty_cache()

    stamp("5ae (accuracy harness)")

    # 5eq. tools/serve_quant_bench_torch.py: the engine over a dense, int8 and
    # int4 UNet, 12 requests of 20 steps over 4 slots; [serve-join] over int4
    import serve_quant_bench_torch

    sim = _PySchedulerCore(SERVE_SLOTS)  # the ticks that run the UNet
    for i in range(SERVE_REQUESTS):
        sim.submit(i, STEPS)
    bench_ticks = 0
    while sim.active() or sim.pending():
        sim.assign()
        bench_ticks += sim.active() > 0
        sim.tick()
    per_tick = unet_launches(sd15.unet, 64, 2 * SERVE_SLOTS)
    for qname in SERVE_QUANT:
        base = serve_quant_bench_torch.bytes_in_use(dev)
        model_q = serve_quant_bench_torch.quantized_model("sd15", qname, dev)
        eng = Engine(model_q, num_slots=SERVE_SLOTS)
        out = serve_quant_bench_torch.bench(eng, SERVE_REQUESTS, STEPS, base,
                                            around=lambda: counted_run(f"serve_{qname}"))
        counts, counted, by_variant = runs[f"serve_{qname}"]
        flash_w = launches_of((bench_ticks, per_tick))[0]
        want_shapes = {kn: {} for kn in wrappers}
        want_shapes.update(flash_packed=flash_w,
                           flash_bhsd={k: SERVE_REQUESTS * n for k, n in vae_512.items()})
        if qname == "fp16":
            want_shapes["geglu"] = launches_of((bench_ticks, per_tick))[1]
        else:
            kname, row_key = qformats[qname][1], qformats[qname][3]
            want_shapes[kname] = {row_key(*mkn): bench_ticks * n for mkn, n in serve_quant.items()}
        want_by_variant = want_variants_of(want_shapes["flash_packed"], want_shapes["flash_bhsd"],
                                           want_shapes["geglu"])
        want_by_variant.update(quant_matmul={}, quant_matmul_int4={})
        if qname != "fp16":
            want_by_variant[kname] = {"wgmma": sum(want_shapes[kname].values())}
        # the counts above are the graph's captured calls times its replays:
        # 2 replayed ticks under the profiler count its kernels by name
        q_ids = serve_quant_bench_torch.prompt_ids(sd15)
        replays, want_replay, launched = replays_by_name(eng, q_ids, 2, 80)
        say(f"[serve-{qname}] launches over {SERVE_REQUESTS} requests, {bench_ticks} ticks: "
            f"{counts}; by variant {by_variant}; 2 replayed ticks under torch.profiler, after "
            f"one that lets it settle: each replay's kernels by name {replays}, graph launches "
            f"{launched} (want {want_replay} each, 3)")
        if counted != want_shapes or by_variant != want_by_variant:
            fail(f"[serve-{qname}] launches {counted} / {by_variant} against {want_shapes} / "
                 f"{want_by_variant}")
        if replays != [want_replay] * 2 or launched != 3:
            fail(f"[serve-{qname}] the replayed ticks ran {replays} in {launched} graph "
                 f"launches, not 2 x {want_replay} in 3")
        for kn, by_shape in counted.items():
            if set(by_shape) - measured(kn):
                fail(f"[serve-{qname}] {kn}: shapes {by_shape} not all measured in phase 3")
        extra_paths[f"serve_{qname}"] = (counts, counted)
        bad = [rid for rid, img in out["images"].items()
               if img.shape != (512, 512, 3) or img.dtype != np.uint8]
        if len(out["images"]) != SERVE_REQUESTS or bad:
            fail(f"[serve-{qname}] {len(out['images'])} images, bad {bad}")
        say(f"[serve-{qname}] tools/serve_quant_bench_torch.py: SD1.5 512x512 bf16, UNet "
            f"{qname}, {SERVE_SLOTS} slots, {SERVE_REQUESTS} requests of {STEPS} DDIM steps "
            f"submitted together after a {serve_quant_bench_torch.WARMUP_STEPS}-step warm-up: "
            f"{out['images_per_s']:.4f} images/s, wall {out['wall_s']:.3f} s "
            f"({out['wall_s'] / bench_ticks * 1e3:.1f} ms a tick), submit -> result p50 "
            f"{out['p50_s']:.3f} s, p95 {out['p95_s']:.3f} s; the model and engine hold "
            f"{out['hbm_gb']:.3f} GB after the warm-up (beyond the {base / 1e9:.3f} GB in use "
            f"before the model was built); conv shapes run a row at a time "
            f"{sum(eng._rows.apart.values())} of {len(eng._rows.apart)}; card {card}")
        if qname == "int4":
            # [serve-join] a request that joins two busy slots (slot 2) against
            # itself alone in the idle engine (slot 0), bit for bit
            join_ids = serve_quant_bench_torch.prompt_ids(sd15)
            for i in range(2):
                eng.submit(eng.make_request(join_ids, join_ids, num_steps=8, seed=70 + i))
            eng.step()
            eng.step()
            late = eng.make_request(join_ids, join_ids, num_steps=6, seed=72)
            eng.submit(late)
            joined = {r.request_id: r.image for r in eng.run_until_idle()}[late.request_id]
            eng.submit(eng.make_request(join_ids, join_ids, num_steps=6, seed=72))
            alone = eng.run_until_idle()[0].image
            diff = np.abs(joined.astype(np.int16) - alone.astype(np.int16))
            say(f"[serve-join] int4 UNet: request seed 72 (6 steps), joined into slot 2 beside "
                f"2 busy slots, against alone in the idle engine (slot 0): "
                f"{int((diff > 0).sum())} of {diff.size} uint8 values differ, max "
                f"{int(diff.max())}")
            if diff.any():
                fail("serve-join int4: a request's image depends on the other requests")
        del eng, model_q, out
        torch.cuda.empty_cache()

    stamp("5eq (quantized serving)")

    # 5mf. tools/memory_footprint_torch.py --preset sd15: the engine step's
    # argument, output and temporary bytes by UNet format ----------------------
    import memory_footprint_torch

    mf_rows = {r["variant"]: r for r in memory_footprint_torch.main(
        ["--preset", "sd15", "--slots", str(SERVE_SLOTS)])}
    say(f"[memory] tools/memory_footprint_torch.py --preset sd15 --slots {SERVE_SLOTS}: "
        f"{json.dumps(list(mf_rows.values()))}; card {card}")
    if not (mf_rows["fp16"]["argument_mb"] > mf_rows["int8"]["argument_mb"]
            > mf_rows["int4"]["argument_mb"] > 0
            and all(r["temp_mb"] >= 0 and r["total_mb"] > 0 for r in mf_rows.values())):
        fail(f"[memory] argument_mb not fp16 > int8 > int4 > 0, or temp / total missing: "
             f"{mf_rows}")
    torch.cuda.empty_cache()

    stamp("5mf (memory footprint)")

    # 5f. training: the UNet's gradients through the kernels, the two
    # fine-tune CLIs' jobs, a train-state file ------------------------------
    sys.path.insert(0, str(ROOT / "examples"))
    import train_full_torch
    import train_lora_torch

    from tinyfusers_tpu_torch import train as train_mod
    from tinyfusers_tpu_torch.models.layers import set_trainable

    # the modules (the ops package's ``linear`` is the function of that name)
    attention_ops = sys.modules["tinyfusers_tpu_torch.ops.attention"]
    linear_ops = sys.modules["tinyfusers_tpu_torch.ops.linear"]

    def plain_kernels(on: bool):
        """Route the ops' kernel calls through the plain versions (autograd
        differentiates them) or back through the kernels' Functions."""
        attention_ops.flash_packed_diff = flash_packed_plain if on else flash_packed_diff
        linear_ops.geglu_matmul_diff = geglu_matmul_plain if on else geglu_matmul_diff

    # [train-grad-unet] the full-width SD1.5 UNet, fp32, batch 1 at 64x64
    ucfg = sd.SD15.unet
    unet_t = unet_mod.UNet(ucfg, device=dev, dtype=torch.float32)
    init_weights(unet_t, seed=21)
    params_t = train_mod.params_of(set_trainable(unet_t), trainable_only=True)
    g_t = torch.Generator(device=dev).manual_seed(22)
    x_t = torch.randn(1, 64, 64, ucfg.in_channels, generator=g_t, device=dev)
    ctx_t = torch.randn(1, 77, ucfg.context_dim, generator=g_t, device=dev)
    cot_t = torch.randn(1, 64, 64, ucfg.out_channels, generator=g_t, device=dev)
    t_t = torch.tensor([500], dtype=torch.int32, device=dev)
    apply_t = train_mod.module_apply(unet_t)

    def unet_grads():
        return train_mod.step.value_and_grad(
            lambda prm: (apply_t(prm, x_t, t_t, ctx_t) * cot_t).sum(), params_t)[1]

    reset_counts()
    t0 = time.perf_counter()
    g_kernel = unet_grads()
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    want_t = unet_launches(ucfg, 64, 1)
    got_t = (dict(flash_packed.shapes), dict(geglu_matmul.shapes))
    if got_t != want_t:
        fail(f"[train-grad-unet] launches by shape {got_t}, want {want_t}")
    plain_kernels(True)
    try:
        g_plain = unet_grads()
    finally:
        plain_kernels(False)
    rels = {n: rel_err(g_kernel[n], g_plain[n])[1] for n in params_t}
    dead = [n for n, gr in g_kernel.items()
            if gr is None or not torch.isfinite(gr).all() or not gr.abs().sum() > 0]
    worst = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    say(f"[train-grad-unet] SD1.5 UNet fp32 batch 1 64x64: {len(params_t)} parameter tensors "
        f"({sum(p.numel() for p in params_t.values()) / 1e6:.1f}M), gradients with the kernels "
        f"({sum(want_t[0].values())} flash_packed, {sum(want_t[1].values())} geglu; "
        f"{kernel_s:.2f} s) against the plain versions: worst per-tensor rel err "
        f"{[(n, f'{r:.3e}') for n, r in worst]} (tol {UNET_GRAD_TOL:.1e}); median "
        f"{sorted(rels.values())[len(rels) // 2]:.3e}; without a finite non-zero gradient: "
        f"{len(dead)}")
    if dead or worst[0][1] > UNET_GRAD_TOL:
        fail(f"[train-grad-unet] {dead[:8]} without gradients, worst {worst}")
    del unet_t, params_t, g_kernel, g_plain, apply_t
    torch.cuda.empty_cache()

    step_pass = unet_launches(sd15.unet, 64, TRAIN_BATCH)  # one UNet forward at batch 4

    def build_job(cli, argv):
        """A CLI's job as its main() builds it, and the seconds it took."""
        t0 = time.perf_counter()
        job = cli.build(cli.parse_args(argv))
        torch.cuda.synchronize()
        return job, time.perf_counter() - t0

    def train_job(tag, job, build_s, remat, what):
        """A warm-up step of a CLI's job, then TRAIN_STEPS steps with the
        counts checked exactly (twice the forward's launches a step with
        remat), finite losses and gradient norms, steps/s, memory, and one
        profiled step's busy share; the counts go to the kernels line."""
        t0 = time.perf_counter()
        m = job.step()
        loss0 = float(m["loss"])
        first_s = time.perf_counter() - t0
        held_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        metrics = [job.step() for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {kn: w.launches for kn, w in wrappers.items()}
        counted = {kn: dict(w.shapes) for kn, w in wrappers.items()}
        by_variant = variants()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [loss0] + [float(mt["loss"]) for mt in metrics]
        gnorms = [float(mt["grad_norm"]) for mt in metrics]
        want = launches_of((TRAIN_STEPS * (2 if remat else 1), step_pass))
        want_shapes = {kn: {} for kn in wrappers}
        want_shapes.update(flash_packed=want[0], geglu=want[1])
        want_by_variant = want_variants_of(want[0], {}, want[1])
        say(f"[{tag}] launches in {TRAIN_STEPS} steps: {counts}; shapes {counted}; flash and "
            f"geglu launches by variant {by_variant}")
        if (counted != want_shapes or by_variant != want_by_variant
                or set(by_variant["flash_packed"]) - set(WGMMA)):
            fail(f"[{tag}] shapes {counted}, variants {by_variant} against {want_shapes}, "
                 f"{want_by_variant}")
        for kn, by_shape in counted.items():
            if set(by_shape) - measured(kn):
                fail(f"[{tag}] {kn}: shapes {by_shape} not all measured in phase 3")
        if not all(map(lambda v: v == v and abs(v) < float("inf"), losses + gnorms)):
            fail(f"[{tag}] losses {losses}, gradient norms {gnorms} not all finite")
        prof = profile(job.step, host_ops=True)
        say(f"[{tag}] {what}: {TRAIN_STEPS / secs:.3f} steps/s, "
            f"{TRAIN_STEPS * TRAIN_BATCH / secs:.3f} samples/s over {TRAIN_STEPS} steps "
            f"({secs:.2f} s); model built in {build_s:.2f} s, first step {first_s:.2f} s; "
            f"held {held_gb:.2f} GB after it, peak {peak_gb:.2f} GB in the steps; optimizer "
            f"state {train_mod.optim.state_bytes(job.state.opt_state) / 1e9:.3f} GB; losses "
            f"{[round(v, 4) for v in losses]}; gradient norms {[round(v, 3) for v in gnorms]}; "
            f"one profiled step: host {prof['host_s']:.3f} s, device {prof['device_ms']:.1f} ms "
            f"in {prof['device_kernels']} kernels, busy share {prof['device_busy_share']:.3f}, "
            f"by group {json.dumps(prof['groups_ms'])} (the raw kineto events and "
            f"prof.events() agree on all {prof['events_agree']} kernels), host's top ops "
            f"{json.dumps(prof['host_top_ops'])}; card {card}")
        extra_paths[tag.replace("-", "_")] = (counts, counted)
        return job

    def overfit(tag, job):
        """OVERFIT_STEPS steps on one batch with the same t and noise each
        step (the generator reseeded): a fixed regression the optimizer must
        drive down, as the JAX package's test_overfit_tiny_unet does. The
        losses then depend on nothing random: the last must be below the
        first, and the last five's mean below the first five's."""
        batch = job.batches()
        losses = []
        for _ in range(OVERFIT_STEPS):
            job.generator.manual_seed(7)
            losses.append(float(job.step(batch)["loss"]))
        say(f"[{tag}] {OVERFIT_STEPS} steps on one batch, t and noise fixed: losses "
            f"{[round(v, 4) for v in losses]}; last / first {losses[-1] / losses[0]:.4f}")
        if not (losses[-1] < losses[0] and sum(losses[-5:]) < sum(losses[:5])):
            fail(f"[{tag}] the loss did not fall: {losses}")

    # [train-full] examples/train_full_torch.py's job: all of the UNet, AdamW, remat
    full_argv = ["--preset", "sd15", "--batch", str(TRAIN_BATCH), "--optimizer", "adamw",
                 "--remat", "--lr", "1e-4"]
    job = train_job("train", *build_job(train_full_torch, full_argv), True,
                    "SD1.5 full fine-tune bf16 batch 4 64x64, AdamW, remat "
                    "(examples/train_full_torch.py " + " ".join(full_argv) + ")")
    overfit("train-overfit", job)

    # [train-resume] the job's train state: a file, read back bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "train_state.safetensors"
        need = train_mod.optim.state_bytes((job.state.params, job.state.opt_state))
        free = shutil.disk_usage(tmp).free
        if free < need * 1.2:
            fail(f"{tmp} has {free / 1e9:.1f} GB free, the train state needs {need / 1e9:.1f}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_mod.save_train_state(job.state, path, job.layouts)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = train_mod.load_train_state(job.state, path, job.layouts)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        size_gb = path.stat().st_size / 1e9

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        items = tree.values() if isinstance(tree, dict) else tree
        return [t for item in items for t in leaves(item)]

    pairs = list(zip(leaves((job.state.params, job.state.opt_state)),
                     leaves((back.params, back.opt_state))))
    differ = sum(not (a.dtype == b.dtype and a.device == b.device and torch.equal(a, b))
                 for a, b in pairs)
    say(f"[train-resume] the full fine-tune's train state at step {job.state.step}: "
        f"{len(pairs)} tensors, a {size_gb:.3f} GB file (the JAX package's keys and layouts), "
        f"saved in {save_s:.2f} s, loaded in {load_s:.2f} s; tensors that differ: {differ}; "
        f"step {back.step}")
    if differ or back.step != job.state.step:
        fail(f"[train-resume] the train state did not read back bit for bit ({differ} differ)")
    del job, back, pairs
    torch.cuda.empty_cache()

    # [train-lora] examples/train_lora_torch.py's job: rank-8 adapters, frozen bf16 base
    lora_argv = ["--preset", "sd15", "--batch", str(TRAIN_BATCH), "--rank", "8", "--lr", "1e-3",
                 "--steps", str(OVERFIT_STEPS)]
    job, build_s = build_job(train_lora_torch, lora_argv)
    base_copy = {k: v.clone() for k, v in job.base.items()}
    job = train_job("train-lora", job, build_s, False,
                    "SD1.5 LoRA rank 8 over a frozen bf16 base, batch 4 64x64, no remat "
                    "(examples/train_lora_torch.py " + " ".join(lora_argv) + ")")
    overfit("train-lora-overfit", job)
    moved = sum(not torch.equal(v, base_copy[k]) for k, v in job.base.items())
    model_moved = sum(not torch.equal(p, base_copy[n]) for n, p in job.unet.named_parameters())
    say(f"[train-lora] after {1 + TRAIN_STEPS + 1 + OVERFIT_STEPS} steps: {len(job.state.params)} "
        f"adapter tensors, {train_mod.optim.state_bytes(job.state.params) / 1e6:.2f} MB; base "
        f"tensors that changed: {moved} of {len(base_copy)}, the model's own: {model_moved}; "
        f"adapters b non-zero: {sum(bool(v.any()) for k, v in job.state.params.items() if k.endswith('.b'))}")
    if moved or model_moved:
        fail(f"[train-lora] the frozen base changed ({moved}, {model_moved})")
    del job, base_copy
    torch.cuda.empty_cache()

    stamp("5f (training)")

    # 7. the kernels line and the contract line ---------------------------
    sources = {"flash_packed": ("tinyfusers_tpu_torch/csrc/flash_attention.cu",
                                "tinyfusers_tpu/kernels/flash_attention.py:117"),
               "flash_packed_multik": ("tinyfusers_tpu_torch/csrc/flash_attention.cu",
                                       "tinyfusers_tpu/kernels/flash_attention.py:172"),
               "flash_bhsd": ("tinyfusers_tpu_torch/csrc/flash_attention.cu",
                              "tinyfusers_tpu/kernels/flash_attention.py:31"),
               "geglu": ("tinyfusers_tpu_torch/csrc/geglu_ff.cu",
                         "tinyfusers_tpu/kernels/geglu_ff.py:48"),
               "quant_matmul": ("tinyfusers_tpu_torch/csrc/quant_matmul.cu",
                                "tinyfusers_tpu/kernels/quant_matmul.py:35"),
               "quant_matmul_int4": ("tinyfusers_tpu_torch/csrc/quant_matmul.cu",
                                     "tinyfusers_tpu/kernels/quant_matmul.py:111")}
    # each entry's paths: launches by path, per-shape counts, what they cover
    def summed(*counts):  # launches by shape over several images
        keys = {k for c in counts for k in c}
        return {k: sum(c.get(k, 0) for c in counts) for k in keys}

    paths = {kn: ({"sd15": launches[kn], "sd21v": sd21_launches[kn]},
                  summed(shapes[kn], sd21_shapes[kn]),
                  "one dense SD1.5 image's and one SD2.1-v image's launches at bf16",
                  "geglu" if kn == "geglu" else "attn")
             for kn in ("flash_packed", "geglu")}
    paths["flash_bhsd"] = (
        {"sd15": launches["flash_bhsd"], "sd21v": sd21_launches["flash_bhsd"],
         "sd3": sd3_launches["flash_bhsd"], "sd3_t5": t5_launches["flash_bhsd"],
         "sd3_file": file_launches["flash_bhsd"]},
        summed(shapes["flash_bhsd"], sd21_shapes["flash_bhsd"], sd3_shapes["flash_bhsd"],
               t5_shapes["flash_bhsd"], file_shapes["flash_bhsd"]),
        "one dense SD1.5 image's, one SD2.1-v image's, one SD3 image's, one SD3 + T5 "
        "image's and one SD3 image's from its file launches at bf16", "attn")
    paths["flash_packed_multik"] = (
        {"sd3": sd3_launches["flash_packed"], "sd3_t5": t5_launches["flash_packed"],
         "sd3_file": file_launches["flash_packed"],
         "parallel_pipe": pipe_multik[0]["flash_packed"]},
        summed(sd3_shapes["flash_packed"], t5_shapes["flash_packed"],
               file_shapes["flash_packed"], pipe_multik[1]["flash_packed"]),
        "one SD3 image's, one SD3 + T5 image's and one SD3 image's from its file "
        "flash_packed launches at bf16, and the pipelined MMDiT's bf16 forward "
        "([parallel-pipe], both ranks)", "attn")
    xl_q = {q: extra_paths[f"sdxl_{q}"][1][qformats[q][1]] for q in ("int8", "fp8", "int4")}
    # the accuracy harness's quantized images and the quantized engines' runs
    new_q = {kn: {path: extra_paths[path][1][kn] for path in paths_q}
             for kn, paths_q in (("quant_matmul", ("accuracy_int8", "accuracy_fp8", "serve_int8")),
                                 ("quant_matmul_int4", ("accuracy_int4", "serve_int4")))}
    paths["quant_matmul"] = (
        {"sd15_int8": q_launches["int8"], "sd15_fp8": q_launches["fp8"],
         "sd3_int8": sum(sd3_quant["int8"].values()),
         "sdxl_int8": sum(xl_q["int8"].values()), "sdxl_fp8": sum(xl_q["fp8"].values()),
         **{path: sum(c.values()) for path, c in new_q["quant_matmul"].items()}},
        summed(q_shapes["int8"], q_shapes["fp8"], sd3_quant["int8"], xl_q["int8"], xl_q["fp8"],
               *new_q["quant_matmul"].values()),
        "the SD1.5 int8 and fp8 images', the SD3 int8 image's (its MMDiT quantized), the "
        f"SDXL-base int8 and fp8 images', the accuracy harness's {ACC_PROMPTS} int8 and "
        f"{ACC_PROMPTS} fp8 images' (accuracy_*) and the int8 engine's {SERVE_REQUESTS} "
        "requests' (serve_int8) launches at bf16", "quant")
    paths["quant_matmul_int4"] = (
        {"sd15_int4": q_launches["int4"], "sd3_int4": sum(sd3_quant["int4"].values()),
         "sdxl_int4": sum(xl_q["int4"].values()),
         **{path: sum(c.values()) for path, c in new_q["quant_matmul_int4"].items()}},
        summed(q_shapes["int4"], sd3_quant["int4"], xl_q["int4"],
               *new_q["quant_matmul_int4"].values()),
        "the SD1.5, SD3 (its MMDiT quantized) and SDXL-base int4 images', the accuracy "
        f"harness's {ACC_PROMPTS} int4 images' and the int4 engine's {SERVE_REQUESTS} "
        "requests' launches at bf16", "quant")
    for kn in ("flash_packed", "flash_bhsd", "geglu"):  # and phases 5n-5i's and 5x's images
        by_path, counted, per_what, family = paths[kn]
        by_path.update({name: c[kn] for name, (c, _) in extra_paths.items()})
        paths[kn] = (by_path, summed(counted, *(sh[kn] for _, sh in extra_paths.values())),
                     per_what + ", one image of each SD1.5 path of phases 5n-5i (ControlNet, "
                     "DeepCache, DeepCache with cached CFG, FreeU, hires fix, img2img, "
                     "inpainting; the four [cn-compose] modes, cn_compose_*), one SDXL-base "
                     "image and one of each quantized one, phase "
                     f"5e's serving run (12 requests over 4 slots), phase 5f's {TRAIN_STEPS} "
                     "timed steps "
                     "of each fine-tune (train: full, remat; train_lora: LoRA), one bf16 "
                     "DiT-XL/2 CFG forward at 256x256 and at 512x512 (dit_256, dit_512), "
                     f"phase 5ae's {ACC_PROMPTS} images of each accuracy-harness variant "
                     "(accuracy_*) and phase 5eq's 12 requests over the dense, int8 and int4 "
                     "engines (serve_fp16, serve_int8, serve_int4) and [parallel-tp2]'s bf16 "
                     "forward on both ranks (parallel_tp2)",
                     family)
    kernels = []
    for kname, by_key in report.items():
        by_path, counted, per_what, family = paths[kname]
        n_launch = sum(by_path.values())
        rows = [dict(r, launches=counted.get(key, 0)) for key, r in by_key.items()]
        per = lambda field: sum(r["launches"] * r[field] for r in rows)  # noqa: E731
        ops_ms = sum(r["launches"] * r["bound_ms"] for r in rows
                     if r["bound_by"] == "operations")
        lib = (None if any(r["library_ms"] is None for r in rows)
               else per("library_ms"))
        entry = {
            "name": kname, "route": "cuda", "source": sources[kname][0],
            "replaces": sources[kname][1], "launches": n_launch,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": per("ms"), "plain_ms": per("plain_ms"), "bound_ms": per("bound_ms"),
            "bound_by": "operations" if ops_ms >= per("bound_ms") / 2 else "bytes",
            "library_ms": lib, "per": per_what, "paths": by_path,
            "wrapper": wrapper_of.get(kname, kname),
            "tolerance": tol[(family, torch.bfloat16)]}
        if family == "quant":
            entry["dense_ms"] = per("dense_ms")
        kernels.append(dict(entry, shapes=rows))
    say(json.dumps({"kernels": kernels}))
    say(f"[time] the whole run {time.perf_counter() - t_start:.1f} s")
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
