#!/usr/bin/env python3
"""Drive the PyTorch / H100 port on one CUDA card and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. print the card's name and power limit (nvidia-smi) and build every
   kernel of the path from this checkout's sources (one nvcc per source,
   sm_90a, started together), with each one's ptxas report;
2. flash kernel phase: at every shape SDXL 1024x1024, SD 1.5 512x512
   (head dims 40, 80, 160; rows "...@sd15") and SD 2.1 768x768 (rows
   "...@sd21") give the flash-attention
   kernel (derived from the UNet and VAE configs), hold the
   kernel against its plain PyTorch version on seeded bf16 inputs (max |d|
   <= 2e-2, mean |d| <= 2e-3: a few bf16 roundings of outputs below 1) and
   time the kernel, the plain version and F.scaled_dot_product_attention
   (a yardstick only; the port never calls it) with CUDA events over
   back-to-back calls, and the kernel and SDPA also by their device time
   under torch.profiler (short kernels are host-bound back to back); each row
   also names the kernel instance it ran (registers per thread as
   compiled, spilled bytes, shared memory bytes, threads, tile sizes) and
   the host time
   of one wrapper call (checks, tensor-map encoding, launch), taken while
   enqueuing 50 calls that the card has not finished; the same at the
   shapes one rank of the patch path gives the kernel (phase 6: L/n local
   queries against all L gathered keys, K and V split from the flattened
   gathered KV, which must be a view of it at B = 1); and the kernel's
   log-sum-exp instances (``return_lse=True``) at the ring attention's chunk
   shapes ("ring_hop_l1", "ring_hop_l2": L/2 queries against one rank's L/2
   keys, d = 64) and at the sequence-parallel decode's ("vae_ring_*": the VAE
   mid attention's L/n queries against one rank's L/n keys, d = 512; the
   1024x1024 and 512x512 decodes at sp 2, the 2048x2048 one at sp 2 and
   sp 4), out and lse against the plain version (lse max |d| <= 1e-3), each
   with the instance's registers and spilled bytes, timed beside the fastest
   of the PyTorch calls that also return the log-sum-exp:
   ``aten._scaled_dot_product_efficient_attention`` and, up to d = 256,
   ``aten._scaled_dot_product_cudnn_attention`` (both with
   ``compute_log_sumexp``) and ``aten._scaled_dot_product_flash_attention``;
   and PixArt-α's self-attention at
   d = 72 (rows "...@pixart": the dense 1024x1024 call (2, 4096, 4096, 16,
   72), one rank of the "dit" run (1, 2048, 4096, 16, 72, its K and V views
   of the gathered KV), a 512x512 call (2, 1024, 1024, 16, 72), and the
   "dit_ring" run's log-sum-exp chunks (1, 2048, 2048, 16, 72)); and SD3's
   joint attention at d = 64 (rows "...@sd3", ``sd3_attention_shapes``:
   the dense 1024x1024 call (2, 4250, 4250, 24, 64) over 154 context and
   4096 image tokens, 96 launches a call; one rank of the "sd3" run (1,
   2202, 4250, 24, 64): 154 context and 2048 image queries against every
   key; the SD3 VAE's mid attention; SD3.5-medium's image-only dual
   attention (2, 4096, 4096, 24, 64), 13 an evaluation; and the
   "sd3_ring" run's log-sum-exp chunks (1, 2202, 2048, 24, 64), the own
   chunk and one hop, and (1, 2202, 154, 24, 64), the static context
   block), the first path where query and KV lengths are both ragged;
   and the DiT's head-sharded layouts at d = 72 (one rank of the
   "dit_ulysses" run (1, 4096, 4096, 8, 72): 8 heads of every token, q, k
   and v views of the all-to-all's receive buffer [B, L, 3C]; and the
   "dit_usp" run's log-sum-exp chunks (2, 2048, 2048, 8, 72)); and
   PipeFusion's chunk passes at d = 72 (rows "pipefusion_chunk@pixart"
   (2, 1024, 4096, 16, 72), CFG folded, and "pipefusion_chunk_cfg@pixart"
   (1, 1024, 4096, 16, 72), CFG split: a chunk's queries against a
   block's whole cache, K and V strided views of its fused [B, 4096, 2C]
   rows; and "pipefusion_warm_cfg@pixart" (1, 4096, 4096, 16, 72), the
   CFG-split run's mega-patch passes):
   each "@sd3" row is held besides in units of the plain result's own
   scale (max |d| / mean |want| <= 0.5, mean |d| / mean |want| <= 1.5e-2,
   about 10x a sound kernel's readings), and the plain result without the
   last KV tile (the 26 ragged keys of 4250 and of 154, a whole tile where
   the length is a multiple) must break those limits, or the check fails
   for want of power (``relative_check``);
3. quant kernel phase: at every (M, K, N) the quantized main path gives
   the quantized-matmul kernel (derived from the UNet config), and at odd
   shapes, for int8 and fp8, on a seeded bf16 activation: hold the
   per-token quantization kernel against compress.quantize (payload and
   scales bit-identical), and the quantized-matmul kernel against its plain
   version in its fp32 contract form (int8 bit-identical; fp8 max |d| <=
   2e-3 * max |ref|, below the bf16 rounding its caller applies next) and
   in the fused form the main path runs (sx and the bf16 cast in the
   epilogue; int8 bit-identical; fp8 <= 8e-3 * max |ref|, one bf16 ulp),
   and that form with the bias (int8 bit-identical to the plain version;
   fp8 bit-identical to the kernel's own output without the bias plus the
   bias, since the two roundings can turn one ulp into two).  Time each
   kernel, its plain version and a library call (torch._int_mm /
   torch._scaled_mm for the product, torch._scaled_mm with row-wise scales
   and bf16 output for the fp8 fused form; yardsticks only) with CUDA
   events over back-to-back calls and, at the path's shapes, by device
   time under torch.profiler; the host time of a fused wrapper call; the
   instance the shape runs (registers, shared memory, tile); and the
   refresh codec, both its kernels (quantize_rows encodes, dequantize_rows
   decodes into the next step's buffer), at every stale-refresh payload the
   comm-knob runs of phase 6 code, fed as the patch context feeds them
   (bf16 KV [1, L/2, 2C] and halo slabs read in place from their
   activation, the rotation a device scalar; decoded from both ranks'
   payloads or a halo's two arrived halves, keeping the rows a partial
   refresh skips): compress_pcpp's payloads one launch each
   ("refresh_compress_pcpp_<kind>_<shape>", int8, k = 2), stepcache_batch's
   step tables in one grouped launch each ("refresh_stepcache_batch_<phase>
   _table", fp8; also with the residual base), bit for bit with their plain
   versions, timed beside them; the transformer knob runs' KV payloads
   ("refresh_dit_knobs_kv2_1x2048x2304", "refresh_sd3_knobs_kv2_1x2048x3072":
   one rank's fused KV of a block at CFG 2 x sp 2, int8, k = 2, one float32
   scale per row of k and one per row of v, the halves read in place as the
   two parts of one segment and decoded as two segments of one launch; also
   with the residual base); PipeFusion's hop ("hop_pipefusion_*": one chunk
   [2, 1024, 1152] with one float32 scale per token row: int8 and fp8 from
   bf16, decoded to bf16; the residual code from a float32 chunk against a
   float32 predictor, decoded onto it in float32), bit for bit; the quant
   rows also cover PixArt-α's DiT
   linears and T5-XXL's (M, K, N) ("...@pixart"; T5's with no launches:
   the text encoder follows ``weight_quant_aux``, which densifies) and
   SD3-medium's MMDiT linears at 1024x1024 with CFG folded ("...@sd3",
   ``sd3_quant_shapes``: M = 2 x 4096 image and 2 x 154 context rows
   through both streams' qkv, out and MLP linears, the modulations at
   M = 2; 985 launches a quantized 4-step call);
4. small-input checks: the tiny SDXL pipeline in bf16 on the card against
   the same pipeline in float32 on the CPU, same weights and latents:
   dense (relative L2 of the latents <= 8e-2; 2.3e-2 measured for bf16 vs
   float32 on a CPU), and with weight_quant int8 / fp8 under
   quant_compute="pallas" (the kernel on the card, its plain version on the
   CPU; <= 8e-2 and <= 2.5e-1, 4.4e-2 and 1.3e-1 measured for bf16 vs
   float32 on a CPU: fp8's 3 mantissa bits round bf16 and float32
   activations differently); and a tiny SD 1.5-shaped pipeline (conv
   projections, head dims 40 and 80, Euler), <= 8e-2; a tiny PixArt
   pipeline (a 2-block DiT of 2 heads of d = 72, the tiny T5, DPM-solver),
   <= 8e-2; tiny SD3 pipelines (a 2-block MMDiT of 2 heads of d = 64, the
   tiny CLIPs and T5, 84 context beside 256 image tokens, flow-euler),
   dense and with weight_quant int8 under quant_compute="pallas", and an
   SD3.5-medium-shaped one (q/k norms, 3 blocks, the first 2 dual), <=
   8e-2, each with its flash and quant launches derived from the config
   (``_tiny_sd3_check``); the tiny PixArt pipeline under PipeFusion at one
   card (4 chunks, graphed on both sides), <= 8e-2; and the step cache
   at the tiny size on the card (interval 2, depth 1, 6 steps), graphed
   (a "shallow" graph) equal to eager bit for bit;
5. main path: DistriSDXLPipeline at full SDXL width (UNet, ViT-L + bigG
   text encoders, SDXL VAE; seeded random bf16 weights), one prompt,
   4 DDIM steps at 1024x1024 -> a finite (1024, 1024, 3) image, three
   times: dense; weight_quant="int8" with weight_quant_aux="int8"; and
   weight_quant="fp8".  The quantized runs use quant_compute="pallas".
   Each pipeline runs eagerly (``set_stepwise(True)``: one untimed call,
   then the measured one), then under CUDA graphs (``prepare`` captures
   them and is timed, one untimed call, the measured one); the graphed
   latent and image must equal the eager ones bit for bit, and a
   "graph_vs_eager" line gives both calls' times and peak memory.
   Every launch count is set to 0 just before each measured call and read
   just after it: flash 4*140 + 1 in each (the decode whole on one card), quant_matmul and quantize_rows
   0 in the dense call and 4*533 + 70 each in each quantized one (derived
   from the config), graph replays counting the launches they captured.
   On the dense pipeline, eagerly and graphed: img2img from a seeded
   1024x1024 image at strength 0.5 of 4 steps (steps 2 and 3 run; flash
   2*140 + 1 for the VAE encoder + 1 for the decoder; graphed equal to
   eager bit for bit), and the handoff, a call to ``denoising_end=0.5``
   then one from ``denoising_start=0.5``, equal to one full call bit for
   bit; then a refiner-layout UNet (SDXL's widths, 5 time ids) resumes the
   base latent to a finite image that ``aesthetic_score`` changes.  Each
   quantized pipeline's UNet tree is saved (``models.weights.save_params``,
   one .npz under build/save_load/), loaded back (``load_params``), moved to
   the card and given to a fresh pipeline, whose graphed call must give the
   saved pipeline's latent and image bit for bit with 4*533 + 70 launches
   of each quant kernel; a "save_load" line a mode (archive bytes, save,
   load, move, build and capture seconds);
5m. the FLOP count (``flops_phase``): ``comm_volume_report(per_phase=True)``
   "flops" of an eager SDXL 1024x1024 pipeline under the step cache
   (interval 2, depth 1) after one 4-step call, and ``cli/profile_macs.py``'s
   line of the SDXL preset at 1024x1024, both counted on fake tensors;
5a. the row-tiled decode: on the card against the CPU at the tiny size,
   then a 2048x2048 SDXL latent decoded in 5 tiles of 64 rows and whole
   (flash at (1, 65536, 65536, 1, 512), a row of the kernel phase), each
   timed with its peak memory (four ranks decode it sequence-parallel in
   phase 6, "decode_sp");
5b. the SD family: DistriSDPipeline at SD 1.5's full width (UNet
   320/640/1280/1280 with 8 heads, ViT-L, SD VAE; seeded random bf16
   weights), 512x512, 4 DDIM steps, eagerly and under CUDA graphs as
   above (bit-identical; flash 4*32 + 1 = 129 a call, the eager call's
   launches by head dim 40/80/160/512 equal to the config's 40/40/48/1),
   then one eager call each with Euler and DPM++ 2M; SD 1.5 with
   weight_quant int8 and fp8 (quant_compute="pallas"), one graphed call
   each, whose quantized linears run at the "@sd15" rows of the quant
   kernel phase (4*136 + 16 launches of each quant kernel); SD 2.1
   (OpenCLIP ViT-H, 5/10/20/20 heads of 64, v-prediction) at 768x768
   under CUDA graphs, one call after ``prepare``;
5c. PixArt-α: DistriPixArtPipeline at 1024x1024 with the DiT of
   ``pixart_config()`` (28 blocks of 1152, 16 heads of d = 72) and
   T5-v1.1-XXL whole (24 layers of 4096, about 4.8 B parameters), the SD
   VAE, seeded random bf16 weights; 4 DPM-solver steps to an image, eagerly
   and then under CUDA graphs, bit for bit (flash 4*28 + 1 a call: d = 72
   112 times, the whole decode's d = 512 once), with each call's time and
   peak memory and the parameter counts; then PipeFusion from the same
   trees at one card (``parallelism="pipefusion"``, 4 chunks of 1024
   tokens, warmup 1): ``prepare`` captures its tick bodies, one untimed
   call, the graphed call (flash 2*28 + 8*28 + 1 = 281: 2 mega-patch passes,
   8 chunk passes, the decode; no step callback, each tick body's device
   ms by CUDA events), the same ticks replayed uncaptured, bit for bit;
   its latent against the dense call's (relative L2, information only);
   then the step drive (``step_drive``) on a stepwise pipeline of the same
   trees at batch_size 2: two requests' solo step runs, then the same two
   joined mid-flight, packed (one dispatch of both rows), one parked to the
   host while the other runs ahead, resumed and packed again at other step
   indices, every image equal to its solo run and the first to the
   monolithic call bit for bit, every dispatch 28 d = 72 launches at (4,
   4096, 4096, 16, 72) (row "step_dit_self@pixart"; a "pixart_step" line);
5d. SD3: DistriSD3Pipeline at 1024x1024 with the MMDiT of ``sd3_config()``
   (24 joint blocks of 1536, 24 heads of d = 64), CLIP-L (768
   projection), OpenCLIP-bigG and T5-v1.1-XXL whole, the SD3 VAE built by
   ``vae_config_from_json`` from its published config (16 latent
   channels, scaling 1.5305, shift 0.0609), seeded random bf16 weights;
   4 flow-euler steps to an image, eagerly and then under CUDA graphs, bit
   for bit (flash 4*24 + 1 = 97 a call: d = 64 96 times, the whole
   decode's d = 512 once; a "graph_vs_eager" line), and one evaluation of
   the SD3.5-medium transformer geometry from its published config.json
   (24 blocks, q/k RMSNorm, dual attention in blocks 0-12, a 384-token
   position grid): a finite velocity, flash 24 + 13 launches
   ("sd35m_geometry"); then the step drive of 5c on SD3-medium (24 d = 64
   launches a dispatch at (4, 4250, 4250, 24, 64), row
   "step_mmdit_joint@sd3"; a "sd3_step" line);
5e. the command-line scripts, in this process: ``run_sdxl --mode
   benchmark`` at 1024x1024 with random weights (1 untimed, 3 timed 4-step
   calls to latents) prints its trimmed-mean latency, and ``sd_example``
   runs img2img from an image written to a temporary directory;
5f. the serve plane (``serve_phase``, run after 5a on 5's trees):
   InferenceServer over ``pipeline_executor_factory`` building
   DistriSDXLPipeline at batch_size 2 (1024x1024, 4 DDIM steps, CUDA
   graphs captured at warmup; its flash and quant rows "...@serve": B = 4
   in the UNet's attention, M doubled in the linears, B = 2 in the
   decode's); five requests run as batches of 2, 2 and 1 (the last padded),
   each a cache hit, flash 561 a dispatch, each image equal to the same
   pipeline's solo call bit for bit; then a second server whose dense
   executor's first call holds 4 GiB and asks for twice the card: the real
   ``torch.OutOfMemoryError`` must be an OOM for ``serve.is_oom``, the
   ladder's weight_quant_on rung builds the int8 key (the dense tree
   quantized, "pallas", captured), the memory allocated when that build
   starts must be within SERVE_MEM_MARGIN of the level before the failed
   call, and three requests run with 2202 launches of each quant kernel a
   dispatch, each image equal to the int8 pipeline's solo call; one
   {"serve": ...} line (per-request queue wait, execute and end-to-end
   seconds, batch sizes, cache hits and misses, the rungs, launches a
   dispatch, the bit-identity results, warmup seconds, peak memory) before
   the last three lines;
5g. the staged serve path (``staged_phase``, on 5's trees): the same
   executors behind ``pipeline_stages`` (encode, denoise, decode workers,
   each stage on a CUDA stream of its own, at most 2 batches resident) and
   a prompt cache; six requests as three batches of 2, the third repeating
   the first's prompts and seeds (one prompt-cache hit), flash 561 a
   dispatch, each image equal to its solo call; a {"staged": ...} line
   (per-stage queue wait and service seconds, the denoise-gap fraction,
   the prompt cache, the memory reserved at warmup);
5h. step batching (``step_phase``, on 5's trees): the step key
   (``exec_mode="step"``: the UNet eager) at batch_size 2, 4 slots, a
   preview every 2 of 6 steps; two requests start together, two join
   after the first step, a fifth arrives with a deadline only a preemption
   meets: the metrics must show packed dispatches (rows over dispatches)
   and one preemption, each round 140 flash launches a dispatch, every
   image equal to its solo call; a carry exported from a packed round
   finishes in a fresh executor bit for bit; then the int8 key packs two
   requests (603 launches of each quant kernel a dispatch: 533 linears and
   the 70 text-KV projections a step recomputes); a {"step": ...} line
   (rounds by width with their ms and launches, the counters, previews and
   time to first preview, the migration, the int8 rounds);
5i. the SLO controller (``controller_phase``, on 5's trees): an
   InferenceServer with ``controller.enabled`` over graphed whole-batch
   executors at batch_size 2 whose build function reads each tier key's
   step cache, wire compression and refresh fraction (warmup 1), the
   default class's p99 target 0.05 s (far below a dispatch); every tier key
   of the default table built before a burst of 12 requests walks the class
   one rung a dispatch (full, step_cache, comm_compress, partial_refresh,
   reduced_steps) into admission control, and the next submission raises
   AdmissionRejectedError; the target relaxed, the idle server retracts to
   full and serves two more there.  Each dispatch's flash launches against
   its tier's plan (4 x 140 + 1 at full, 3 x 140 + 20 + 1 with one shallow
   step, 2 x 140 + 1 at reduced_steps), every image equal to its tier
   key's solo call; a {"controller": ...} line (the walk, the transitions,
   each tier's build and dispatch seconds);
5j. the gateway (``gateway_phase``): a step-batching server (5h's
   executors, 6 steps, a preview every 2) behind ``gateway.port=0`` on
   127.0.0.1 with the tenants "interactive" (weight 4) and "bulk" (weight
   1, a token bucket of 2); one request over the wire (SSE: queued, three
   previews, final) and the same through ``submit`` (both e2e times), four
   requests of both tenants together, bulk's third a 429, one cancelled
   while queued, a status poll; every final image decoded from the wire
   equal to the in-process result and the solo call; a {"gateway": ...}
   line;
5k. the fleet (``fleet_phase``): ``build_fleet`` with two step-batching
   replicas on this card over the same trees (r0 weight 10, auto_restart);
   the "replica" fault site kills r0 at its fourth step round, its dying
   scheduler exports both carries and r1 finishes them, two more requests
   run on r1 while the tick rebuilds r0, and one runs on the rebuilt r0;
   then two graphed whole-batch replicas: r0 drained and restarted on a
   thread (its build and CUDA graph capture) while r1 replays its graphs
   for four requests, then one on r0 (561 flash launches a dispatch: the
   capture counts none of r1's launches); every image equal to its solo
   call; a {"fleet": ...} line (the failover time, the restarts' warm
   times, r1's rounds and dispatches during them);
5l. autoscale (``autoscale_phase``): the same replicas, min 1 and max 2,
   the tick driven by hand: only r0 warms at start, a burst of 8 scales r1
   up (it builds while r0 serves), two 12-step stragglers, one a replica,
   leave the pressure low and the tick drains r1 with ``release=True`` and
   a 0.3 s deadline: its carry finishes on r0, bit for bit with its solo
   call; an {"autoscale": ...} line (the scale-up's warm time);
6. multi-rank phase, one spawned process a rank: every rank on this one
   card in a gloo group whose CUDA payloads are staged through pinned host
   memory, or one card a rank over NCCL where the machine has four (a line
   names the transport).  Three runs, each with tiny checks at its world
   (bf16 on the card vs float32 on the CPU, relative L2 <= 8e-2, as the
   dense tiny check) and one full-width 4-step 1024x1024 SDXL call: the
   displaced patch path at world 4 (CFG 2 x sp 2, warmup 1: 2 synchronous
   and 2 stale steps; tiny checks full_sync and corrected_async_gn; one
   untimed call first), naive patch parallelism at world 4 (CFG 2 x sp 2,
   ``split_scheme="alternate"``), tensor parallelism (``tp_layout``:
   tp 2 at world 2 on one card, tp 4 on four cards) and SD 1.5's
   displaced patch path at 512x512 (world 4, CFG 2 x sp 2, ``stale_gn``,
   the reference's SD example mode, warmup 1; tiny check with the SD
   1.5-shaped tiny pipeline); and three comm-knob runs of the patch path
   at world 4 (CFG 2 x sp 2, warmup 1): ``ring`` (attn_impl="ring"),
   ``compress_pcpp`` (int8, refresh_fraction 0.5, 6 steps) and
   ``stepcache_batch`` (step cache interval 2 depth 1, comm_batch, fp8),
   each with tiny checks (int8_residual and fp8 too) and its flash,
   log-sum-exp and codec launches against the counts derived from the UNet
   config (``knob_expected``: one quantize_rows and one dequantize_rows a
   compressed payload in every stale step, or one of each a flush under
   comm_batch), its per-phase comm bytes and
   ``comm_plan``, its step times by evaluation and its latent against the
   plain patch run of as many steps (information only).  The patch run also runs one img2img call
   at strength 0.75 of 4 steps: steps 1-3, {sync: 2, stale: 1}, the same
   image on every rank.  ``dp``: data parallelism at world 4, two image
   groups of sp 2 (``dp_degree=2``, ``batch_size=2``, ``split_batch=False``),
   two prompts, a tiny check of two prompts too: both images on every
   rank.  ``serve_ranks``: serving over the spawn's ranks (serve/ranks.py
   ``serve_over_ranks``; ``_serve_ranks_rank``), SDXL 1024x1024 at CFG 2 x
   sp 2, warmup 1, executors at batch_size 2 (the "@serve_ranks" rows):
   rank 0's InferenceServer serves three requests whole-batch (batches of
   2 and 1), four staged (two batches), three step-batched (one joining
   late) and a fourth stopped at step 2 whose carry every rank exports and
   a second server imports, and one at the SLO controller's comm_compress
   tier (the codec's kernels on every rank); one "serve_ranks" line a part
   and rank, every rank's launches against the closed form
   (``serve_ranks_expected``), every image the world-4 solo call's bit for
   bit.  ``ranks_recover`` (queue 3 fault 9; ``_ranks_recover_rank``, a
   spawn of its own before the others; over NCCL the transformer runs and
   the decode take a spawn of their own too, each spawn bounded by
   SPAWN_DEADLINE_S): the serve_ranks layout behind
   ``serve_over_ranks`` with a watchdog bound of RECOVER_WATCHDOG_S; rank 1
   alone first raises a real out-of-memory in the middle of a denoise (4
   GiB held, twice the card asked for, at its second scheduler step), then
   hangs there RECOVER_HANG_S: each time every rank aborts its data groups
   and rebuilds them and its executors, the ladder walks to weight_quant_on
   (the int8 key, "pallas") after the out-of-memory and retries after the
   hang, the server never turns "fatal", and both requests of each part
   equal the solo calls at the rebuilt key bit for bit; a "ranks_recover"
   line a part and rank (the seconds from the abort to the first image,
   the rebuild's and the executors' build and capture seconds, the second
   dispatch's launches against the closed form).  ``dit`` and ``dit_ring``: DistriPixArtPipeline at world 4 (CFG 2 x
   sp 2, warmup 1: 2 synchronous and 2 stale steps, DPM-solver) through
   ``DiTDenoiseRunner``'s "gather" and "ring" layouts, the DiT whole, T5-XXL
   at full width cut to ``SPAWN_T5_LAYERS`` layers (four copies share the
   card; the line says how many), with tiny checks (full_sync too for
   "dit"), flash 4*28 (ring: 2*4*28 log-sum-exp) + 2 a call and the runner's
   ``comm_report``.  ``sd3`` and ``sd3_ring``: DistriSD3Pipeline at world 4
   (CFG 2 x sp 2, warmup 1, flow-euler) through ``MMDiTDenoiseRunner``'s
   "gather" and "ring" layouts, the MMDiT whole, T5-XXL at full width cut
   to ``SPAWN_T5_LAYERS`` layers, with tiny checks (full_sync too for
   "sd3"), flash 4*24 (ring: 3*4*24 log-sum-exp: the own chunk, the static
   context block, one hop) + 2 a call, the runner's ``comm_report`` and
   ``comm_plan``.  The transformer runners' comm knobs and the DiT's
   head-sharded layouts, each run with its tiny checks and its flash,
   log-sum-exp, codec and all-to-all counts derived from the config
   (``transformer_expected``), its ``comm_report``, ``comm_plan``, refresh
   bytes by phase and step times by evaluation: ``dit_knobs`` and
   ``sd3_knobs`` (CFG 2 x sp 2, warmup 1, int8 refreshes with
   ``refresh_fraction=0.5``, the step cache at interval 2 and depth 14 of
   28 / 12 of 24, 6 steps: 2 synchronous, 2 stale, 2 shallow; flash 142 and
   122 a rank, one encode and one decode launch a refreshed block: 84 and
   72; tiny checks at depth 1, int8_residual and fp8 too, and for SD3 an
   SD3.5-medium-shaped one with its dual prefix), ``dit_ulysses`` (CFG 2 x
   sp 2, 4 steps: flash 114, 224 all-to-alls a rank; tiny check full_sync
   too) and ``dit_usp`` (sp 4 with the CFG branches folded,
   ``ulysses_degree=2``: 228 log-sum-exp launches, 224 all-to-alls; tiny
   checks at ``ulysses_degree`` 1 and 4, the latter on a 4-head tiny DiT).
   ``pipefusion``, ``pipefusion_cfg`` and ``pipefusion_knobs``:
   DistriPixArtPipeline under PipeFusion (parallel/pipefusion.py; the DiT's
   blocks as 4 or 2 pipeline stages, 4 chunks of 1024 tokens, warmup 1)
   at sp 4 with the CFG folded, at CFG 2 x sp 2, and at sp 4 with
   int8_residual hops and the step cache (interval 2, the last stage
   passing through every other step after the warmup; 6 steps): its ticks
   run only as captured graphs, so with ranks sharing the card each rank
   checks that ``use_cuda_graph=True`` is refused for the staging and
   False by PipeFusion, and runs nothing; over NCCL each rank holds only
   its stage's blocks (the others freed before the calls), runs the tiny
   check at this world (a 4-block tiny DiT, graphed on the card and on the
   CPU), ``prepare``, one untimed call, the graphed call and the same
   ticks replayed uncaptured (bit for bit, or within 1e-3 relative L2),
   each with the flash and codec launches and tick passes derived from the
   config (``pipefusion_counts``), the tick bodies' device ms, peak memory,
   weight bytes, ``comm_report``, ``comm_plan`` and hop bytes a step.
   ``decode_sp``: the tiny VAE's sequence-parallel decode on the
   card against the CPU at world 4 (relative L2 <= 8e-2), then a 2048x2048
   SDXL latent decoded sequence-parallel at sp 4 and at CFG 2 x sp 2 through
   ``pipelines.decode_latents``, each rank's ms and peak memory and d = 512
   launches (n log-sum-exp, 0 plain), rank 0 also decoding it whole in bf16
   and in float32: each image no further from the float32 one than the bf16
   whole decode, times 1.05 (relative L2; its distance to the bf16 whole
   decode printed beside it).  The pipelines of the
   image-in-patches runs decode sequence-parallel: 2 log-sum-exp launches
   of the d = 512 instance a call, none of the plain one (derived from the
   config, ``decode_launches``).  On every rank: a finite image, the same
   bit for bit on all ranks, 4*140 + 2 flash launches (SD 1.5: 130;
   tensor parallelism, which decodes whole: 4*140 + 1), the
   steps by phase, with the wall time, step times, peak
   memory and the patch path's stale buffers by layer kind.  With ranks
   sharing the card, ``use_cuda_graph=True`` must be refused and the runs
   are eager; over NCCL each runs eagerly and under CUDA graphs, the
   graphed latent bit-identical to the eager one or within 1e-3 relative
   L2 (the line says which).  The patch image against the single-card
   dense one (same weights and noise) is printed for information only.

Every phase's call reads the launch counts it set to 0 just before it.
It prints one JSON line per kernel shape, a card line, the kernels line
(each kernel's main-path numbers, and the same for every other path:
img2img, the handoff, the refiner, the 2048x2048 decodes, the CLI calls,
SD 1.5's quantized calls), and last the line {"ok": true, "device": {...}}.

``--profile`` runs only the warm main path under torch.profiler, eagerly
and under CUDA graphs, for SDXL dense, int8 and fp8 (``--weight_quant``
picks one), SD 1.5 dense at 512x512 and PixArt-α and SD3-medium dense at
1024x1024.  ``--patch_only`` runs only the flash kernel at the multi-rank
shapes (the log-sum-exp rows too), the refresh quantization rows and the
multi-rank phase; with ``--profile`` each rank also
profiles one more call of each run in each mode, with the device
activities (kernel launches, NCCL's and memory copies included) of each
step by the evaluation it ran (``launches_by_phase``) and an "overlap"
line per run, rank and mode: for each stale and shallow step its NCCL
kernels' own device time, the share of it that lies under the rank's
compute kernels and the exposed NCCL time (``stale_step_overlap``).  ``--runs a,b``
(with ``--patch_only``) runs only those multi-rank runs, without the
kernel rows and the kernels line.
``--conv_probe`` runs only ``conv_probe``: why ops/conv.py convolves one
image a launch on the card, and what it costs.
``--serve_only`` runs only 5f-5l with the "@serve" kernel rows (a kernels
line of the flash kernel, quant_matmul and quantize_rows at the serve
phases' launches; the flash entry's paths serve_controller, serve_gateway,
serve_fleet and serve_autoscale).
``--quant_device_times`` runs only the device time of the quantized-matmul
kernel's fp32 contract form and of the per-token quantization kernel at
every SDXL and SD 1.5 path shape, the latter also with a cold L2 (a 256 MB
read before each call), through nothing but ``quant_matmul(xq, wq, sw)``,
``quantize_rows(x, mode)``, ``quantize`` and ``quantize_weight``, so that
it also runs against an older checkout of the package that has
``quantize_rows(x, mode)``: run this file from that checkout's root as
``python3 -c "import runpy, sys; sys.argv[1:] = ['--quant_device_times'];
runpy.run_path('/path/to/chip_smoke.py', run_name='__main__')"``
to compare two kernels by device time in one call.  With
``--encoder_source PATH`` it times the per-token quantization built from
another source (a variant of csrc/quantize_rows.cu with the same entry
points, beside a copy of csrc/refresh_codec.cuh) and reports whether its
payloads still equal the plain version's.  It exits non-zero without a
result when no CUDA card is present or the package is missing.
"""

import datetime
import gc
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_8BIT_OPS = 1979e12  # H100 SXM dense int8 / fp8 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
KERNEL_MAX_ABS, KERNEL_MEAN_ABS = 2e-2, 2e-3
LSE_MAX_ABS = 1e-3
# the "@sd3" rows besides: |d| in units of the plain result's own scale
# (max and mean |d| over mean |want|), about 10x a sound kernel's reading;
# the plain result without the last KV tile must break them
# (``relative_check``)
SD3_REL_MAX, SD3_REL_MEAN = 0.5, 1.5e-2
QUANT_FP8_REL = 2e-3  # fp32 contract form
QUANT_FP8_FUSED_REL = 8e-3  # bf16 fused form: one bf16 ulp
QUANT_TARGET_MS = 15.0  # CUDA-event timing window per quant-phase measurement
HOST_CALLS = 50  # wrapper calls whose host time is taken per kernel shape
TINY_REL_L2 = {"none": 8e-2, "int8": 8e-2, "fp8": 2.5e-1}
ODD_QUANT_SHAPES = ((33, 72, 50), (64, 64, 48), (128, 256, 130), (17, 2816, 320))
CHECK_DEVICES = (("cpu", "float32"), ("cuda", "bfloat16"))
TEXT_LEN = 77
PROMPT = "a photo of an astronaut riding a horse on mars"
PATCH_WORLD, PATCH_STEPS, PATCH_WARMUP = 4, 4, 1  # CFG 2 x sp 2: 2 sync, 2 stale
PATCH_MODES = ("full_sync", "corrected_async_gn")
# image size of each model family's pipeline runs; SD 1.x and SD 2.x rows of
# the kernel phase carry the suffix "@sd15" or "@sd21" after their shape name
SIZES = {"sdxl": 1024, "sd15": 512, "sd21": 768, "pixart": 1024, "sd3": 1024}
SD15, SD21, PIXART, SD3 = "@sd15", "@sd21", "@pixart", "@sd3"
# the serve phase (``serve_phase``): SDXL at 1024x1024 behind
# InferenceServer, executors prepared at batch_size SERVE_BATCH (CFG folds
# the UNet's B to 4; the decode takes both images at once); its kernel-phase
# rows carry the suffix "@serve".  Five requests (batches of 2, 2 and 1,
# the last padded), then three through a second server whose dense
# executor's first call runs out of memory for real: it holds
# SERVE_HELD_BYTES, then asks for twice the card; the ladder's
# weight_quant_on rung rebuilds the key as int8, and the memory allocated
# when the rebuild starts must be within SERVE_MEM_MARGIN of the level
# before the failed call (the failed call's frames released)
SERVE = "@serve"
SERVE_BATCH = 2
SERVE_REQUESTS = [(f"{PROMPT}, served #{i}", 100 + i) for i in range(5)]
SERVE_OOM_REQUESTS = 3
SERVE_HELD_BYTES = 4 << 30
SERVE_MEM_MARGIN = 256 << 20
SERVE_WINDOW_S = 0.5  # the batcher holds a leader this long for its follower
# the staged phase (``staged_phase``): the serve phase's executors behind the
# three-stage worker pipeline (pipeline_stages, max_inflight_batches 2) with
# the prompt cache; six requests as three batches of 2, the last batch the
# first one again (same prompts and seeds: a prompt-cache hit)
STAGED_REQUESTS = [(f"{PROMPT}, staged #{i}", 300 + i) for i in range(4)]
STAGED_REQUESTS += STAGED_REQUESTS[:2]
STAGED_INFLIGHT, STAGED_PROMPT_CACHE = 2, 8
# the step phase (``step_phase``): step-level continuous batching over the
# same trees, executors at batch_size SERVE_BATCH (a packed dispatch carries
# 2 requests at B = 4 with the CFG folded: the "@serve" rows), STEP_SLOTS
# slots, a preview every STEP_PREVIEW steps, STEP_STEPS DDIM steps a request
# (room for a request to join mid-denoise and one to be preempted)
STEP_SLOTS, STEP_PREVIEW, STEP_STEPS = 4, 2, 6
STEP_REQUESTS = [(f"{PROMPT}, step #{i}", 400 + i) for i in range(5)]
STEP_INT8_REQUESTS = [(f"{PROMPT}, step int8 #{i}", 500 + i) for i in range(2)]
# the SLO controller phase (``controller_phase``): whole-batch executors at
# batch_size SERVE_BATCH, a class target far below a dispatch, so that a burst
# of CTRL_REQUESTS walks the default tier table one rung a dispatch
# (escalation cooldown CTRL_COOLDOWN_S, below any dispatch) into admission
# control; then the operator relaxes the target to CTRL_RELAXED_S and the idle
# server retracts to full (a target below an idle dispatch could never let it)
CTRL_REQUESTS = [(f"{PROMPT}, tier #{i}", 600 + i) for i in range(12)]
CTRL_AFTER = [(f"{PROMPT}, back at full #{i}", 620 + i) for i in range(2)]
CTRL_TARGET_S, CTRL_COOLDOWN_S, CTRL_RELAXED_S, CTRL_PRIOR_S = 0.05, 0.25, 30.0, 0.74
CTRL_WARMUP = 1  # the step cache's tiers then run shallow steps at 4 steps
# the gateway phase (``gateway_phase``): a step-batching server behind the
# HTTP/SSE gateway on 127.0.0.1, two tenants: "interactive" (weight 4) and
# "bulk" (weight 1, a token bucket of GATEWAY_BULK_BURST requests refilled at
# GATEWAY_BULK_RATE a second, so its third request is a 429)
GATEWAY_ALONE = (f"{PROMPT}, over the wire", 700)
GATEWAY_REQUESTS = [(f"{PROMPT}, wire #{i}", 710 + i, t)
                    for i, t in enumerate(("interactive", "bulk", "interactive", "bulk"))]
GATEWAY_BULK_BURST, GATEWAY_BULK_RATE = 2.0, 0.001
# the fleet phase (``fleet_phase``): two step-batching replicas on this card
# over the same trees; the "replica" fault site kills r0 (weight 10, so it
# takes the first requests) at its FLEET_KILL_AFTER + 1-th step round;
# auto_restart rebuilds it while r1 serves the migrated carries and
# FLEET_EXTRA requests sent after the kill
FLEET_REQUESTS = [(f"{PROMPT}, fleet #{i}", 800 + i) for i in range(2)]
FLEET_EXTRA = [(f"{PROMPT}, after the kill #{i}", 810 + i) for i in range(2)]
FLEET_AFTER_RESTART = (f"{PROMPT}, on the restarted replica", 820)
FLEET_KILL_AFTER = 3
# then two graphed whole-batch replicas (r0 weight 10): r0 drained and
# restarted on a thread -- a build and a CUDA graph capture -- while r1
# replays its graphs for FLEET_GRAPHED; then FLEET_GRAPHED_AFTER on r0
FLEET_GRAPHED = [(f"{PROMPT}, graphed fleet #{i}", 830 + i) for i in range(4)]
FLEET_GRAPHED_AFTER = (f"{PROMPT}, on the recaptured replica", 840)
FLEET_GRAPHED_STEPS = 4
# the autoscale phase (``autoscale_phase``): the same replicas, min 1, max 2;
# a burst of AUTO_BURST requests scales r1 up, then two AUTO_LONG_STEPS-step
# stragglers (one a replica) at low pressure scale it down through a drain
# of AUTO_DRAIN_S, its straggler's carry migrating to r0
AUTO_BURST = [(f"{PROMPT}, burst #{i}", 900 + i) for i in range(8)]
AUTO_LONG = [(f"{PROMPT}, straggler #{i}", 920 + i) for i in range(2)]
# the "serve_ranks" multi-rank run (``_serve_ranks_rank``): serving over the
# world-4 spawn's ranks (serve/ranks.py ``serve_over_ranks``), SDXL at
# 1024x1024, CFG 2 x sp 2, warmup 1, executors at batch_size SERVE_BATCH:
# each rank holds 2 rows of one branch (its kernel-phase rows carry the
# suffix "@serve_ranks"; the decode takes both images).  Rank 0's server
# serves SERVE_RANKS_REQUESTS[:3] whole-batch (batches of 2 and 1), all four
# staged (two batches), three step-batched (the third joining late) and the
# fourth stopped at step SERVE_RANKS_EXPORT_AT, its carry exported from every
# rank and imported by a second server, and the first at the knobs of the
# SLO controller's SERVE_RANKS_TIER tier
SERVE_RANKS = "@serve_ranks"
SERVE_RANKS_REQUESTS = [(f"{PROMPT}, over ranks #{i}", 1000 + i) for i in range(4)]
SERVE_RANKS_EXPORT_AT, SERVE_RANKS_SLOTS = 2, 3
SERVE_RANKS_TIER = "comm_compress"
# the ranks_recover run (``_ranks_recover_rank``): a failure on rank 1 alone
# inside a denoise of the serve_ranks layout, first a real out-of-memory at
# its RECOVER_FAULT_STEP-th scheduler step (SERVE_HELD_BYTES held, twice the
# card asked for), then a hang there of RECOVER_HANG_S, past the watchdog
# bound RECOVER_WATCHDOG_S; two requests a part
RECOVER_REQUESTS = [(f"{PROMPT}, recovered #{i}", 1100 + i) for i in range(2)]
RECOVER_WATCHDOG_S, RECOVER_HANG_S, RECOVER_FAULT_STEP = 30.0, 45.0, 2
AUTO_LONG_STEPS, AUTO_DRAIN_S = 12, 0.3
# the transformer families' step drive (``step_drive``): executors at
# batch_size 2, so a dispatch runs the DiT / MMDiT at B = 4 with the CFG folded
STEP = "_step"
SD15_HEAD_DIMS = (40, 80, 160)
CODEC_TABLE = 192  # segments a refresh-codec launch takes (ops/quantize.py CAPACITY)
SPAWN_DEADLINE_S = 720  # one spawn of the multi-rank phase, profiles included
GRAPH_REL_L2 = 1e-3  # graphed vs eager latent over NCCL, where not bit-identical
# the multi-rank runs: config fields, tiny checks (extra fields each), steps
# by phase; tensor parallelism without the CFG split (B = 2 on every rank)
# and the model family (SD 1.5's patch run is the reference's sd_example
# mode, stale_gn)
# and the steps of its call; the comm-knob runs (``KNOB_RUNS``) are the
# displaced patch path at CFG 2 x sp 2 with the JAX package's knobs
MULTI_RUNS = {
    "patch": ({"warmup_steps": PATCH_WARMUP}, [{"mode": m} for m in PATCH_MODES],
              {"sync": PATCH_WARMUP + 1, "stale": PATCH_STEPS - PATCH_WARMUP - 1}, "sdxl",
              PATCH_STEPS),
    "ring": ({"warmup_steps": PATCH_WARMUP, "attn_impl": "ring"},
             [{}, {"mode": "full_sync"}], {"sync": 2, "stale": 2}, "sdxl", PATCH_STEPS),
    "compress_pcpp": ({"warmup_steps": PATCH_WARMUP, "comm_compress": "int8",
                       "refresh_fraction": 0.5},
                      [{}, {"comm_compress": "int8_residual"}],
                      {"sync": 2, "stale": 4}, "sdxl", 6),
    "stepcache_batch": ({"warmup_steps": PATCH_WARMUP, "step_cache_interval": 2,
                         "step_cache_depth": 1, "comm_batch": True, "comm_compress": "fp8"},
                        [{}, {"comm_compress": "int8_residual"}],
                        {"sync": 2, "stale": 1, "shallow": 1}, "sdxl", PATCH_STEPS),
    "naive_patch": ({"parallelism": "naive_patch", "split_scheme": "alternate"}, [{}],
                    {"sync": PATCH_STEPS, "stale": 0}, "sdxl", PATCH_STEPS),
    "tensor": ({"parallelism": "tensor", "split_batch": False}, [{}],
               {"sync": PATCH_STEPS, "stale": 0}, "sdxl", PATCH_STEPS),
    "sd15_patch": ({"mode": "stale_gn", "warmup_steps": PATCH_WARMUP}, [{}],
                   {"sync": PATCH_WARMUP + 1, "stale": PATCH_STEPS - PATCH_WARMUP - 1},
                   "sd15", PATCH_STEPS),
    # two image groups of sp 2 (the displaced path, CFG folded), one prompt
    # each; its tiny check takes two prompts too
    "dp": ({"dp_degree": 2, "batch_size": 2, "split_batch": False,
            "warmup_steps": PATCH_WARMUP}, [{"prompts": 2}],
           {"sync": PATCH_WARMUP + 1, "stale": PATCH_STEPS - PATCH_WARMUP - 1}, "sdxl",
           PATCH_STEPS),
    # serving over the ranks (``_serve_ranks_rank``): the patch run's layout
    # at batch_size 2 behind rank 0's InferenceServer; no tiny check
    "serve_ranks": ({"warmup_steps": PATCH_WARMUP, "batch_size": SERVE_BATCH}, [],
                    {"sync": PATCH_WARMUP + 1, "stale": PATCH_STEPS - PATCH_WARMUP - 1},
                    "sdxl", PATCH_STEPS),
    # PixArt-α's DiT under displaced patch parallelism (parallel/dit_sp.py),
    # its two layouts, DPM-solver as the pipeline's default
    "dit": ({"warmup_steps": PATCH_WARMUP}, [{}, {"mode": "full_sync"}],
            {"sync": 2, "stale": 2}, "pixart", PATCH_STEPS),
    "dit_ring": ({"warmup_steps": PATCH_WARMUP, "attn_impl": "ring"}, [{}],
                 {"sync": 2, "stale": 2}, "pixart", PATCH_STEPS),
    # SD3-medium's MMDiT under displaced patch parallelism
    # (parallel/mmdit_sp.py), its two layouts, flow-euler
    "sd3": ({"warmup_steps": PATCH_WARMUP}, [{}, {"mode": "full_sync"}],
            {"sync": 2, "stale": 2}, "sd3", PATCH_STEPS),
    "sd3_ring": ({"warmup_steps": PATCH_WARMUP, "attn_impl": "ring"}, [{}],
                 {"sync": 2, "stale": 2}, "sd3", PATCH_STEPS),
    # the transformer runners' comm knobs (the gather refresh int8 with one
    # scale per k and per v row, every other token row a stale step; the step
    # cache at interval 2 cutting half the blocks) and the DiT's head-sharded
    # layouts; the tiny checks cut at their own depth ("heads": the tiny
    # DiT's head count, "model": the tiny MMDiT's shape)
    "dit_knobs": ({"warmup_steps": PATCH_WARMUP, "comm_compress": "int8",
                   "refresh_fraction": 0.5, "step_cache_interval": 2,
                   "step_cache_depth": 14},
                  [{"step_cache_depth": 1},
                   {"step_cache_depth": 1, "comm_compress": "int8_residual"},
                   {"step_cache_depth": 1, "comm_compress": "fp8", "refresh_fraction": 1.0}],
                  {"sync": 2, "stale": 2, "shallow": 2}, "pixart", 6),
    "sd3_knobs": ({"warmup_steps": PATCH_WARMUP, "comm_compress": "int8",
                   "refresh_fraction": 0.5, "step_cache_interval": 2,
                   "step_cache_depth": 12},
                  [{"step_cache_depth": 1},
                   {"step_cache_depth": 1, "comm_compress": "int8_residual"},
                   {"step_cache_depth": 1, "comm_compress": "fp8", "refresh_fraction": 1.0},
                   {"step_cache_depth": 1, "model": "sd35m"}],
                  {"sync": 2, "stale": 2, "shallow": 2}, "sd3", 6),
    "dit_ulysses": ({"warmup_steps": PATCH_WARMUP, "attn_impl": "ulysses"},
                    [{}, {"mode": "full_sync"}], {"sync": 2, "stale": 2}, "pixart",
                    PATCH_STEPS),
    "dit_usp": ({"warmup_steps": PATCH_WARMUP, "attn_impl": "usp", "ulysses_degree": 2,
                 "split_batch": False},
                [{}, {"ulysses_degree": 1}, {"ulysses_degree": 4, "heads": 4}],
                {"sync": 2, "stale": 2}, "pixart", PATCH_STEPS),
    # PixArt-α's DiT as PipeFusion's pipeline stages (parallel/pipefusion.py),
    # 4 chunks of 1024 tokens, graphed only (its ticks are captured bodies):
    # sp 4 with the CFG folded; CFG 2 x sp 2; sp 4 with int8_residual hops and
    # the step cache skipping the last stage every other step after the
    # warmup; tiny checks on a 4-block tiny DiT (one or two blocks a stage);
    # steps by phase: each rank's tick passes (``pipefusion_counts``)
    "pipefusion": ({"parallelism": "pipefusion", "warmup_steps": PATCH_WARMUP,
                    "split_batch": False, "pipe_patches": 4},
                   [{"depth": 4}], None, "pixart", PATCH_STEPS),
    "pipefusion_cfg": ({"parallelism": "pipefusion", "warmup_steps": PATCH_WARMUP,
                        "pipe_patches": 4}, [{"depth": 4}], None, "pixart", PATCH_STEPS),
    "pipefusion_knobs": ({"parallelism": "pipefusion", "warmup_steps": PATCH_WARMUP,
                          "split_batch": False, "pipe_patches": 4,
                          "comm_compress": "int8_residual", "step_cache_interval": 2,
                          "step_cache_depth": 1},
                         [{"depth": 4}], None, "pixart", 6),
}
DIT_RUNS = ("dit", "dit_ring", "dit_knobs", "dit_ulysses", "dit_usp")
PIPEFUSION_RUNS = ("pipefusion", "pipefusion_cfg", "pipefusion_knobs")
SD3_RUNS = ("sd3", "sd3_ring", "sd3_knobs")
# the transformer runs whose stale refreshes go through the refresh codec
TRANSFORMER_KNOB_RUNS = ("dit_knobs", "sd3_knobs")
# T5-XXL layers of the multi-rank PixArt runs (full width; four ranks on one
# card each hold a copy); the single-card PixArt call runs all 24
SPAWN_T5_LAYERS = 6
# PixArt-α's self-attention (16 heads of d = 72, 28 blocks) as the flash
# kernel sees it, with its launches in one 4-step call: the dense 1024x1024
# call (CFG folded, B = 2), one rank of the "dit" run at CFG 2 x sp 2 (2048
# queries against the gathered 4096 keys) and a dense 512x512 call
PIXART_STEPS, PIXART_DEPTH = 4, 28
# (the dense call's row first, then the multi-rank rows PIXART_SHAPES[1:3]:
# one "dit" rank's and one "dit_ulysses" rank's); "dit_ulysses" at CFG 2 x sp 2: each rank's 8 heads
# of every token, q, k and v views of the all-to-all's receive buffer
PIXART_SHAPES = (
    ("dit_self" + PIXART, 2, 4096, 4096, 16, 72, PIXART_STEPS * PIXART_DEPTH),
    ("patch_dit_self" + PIXART, 1, 2048, 4096, 16, 72, PIXART_STEPS * PIXART_DEPTH),
    ("dit_ulysses_self" + PIXART, 1, 4096, 4096, 8, 72, PIXART_STEPS * PIXART_DEPTH),
    ("dit512_self" + PIXART, 2, 1024, 1024, 16, 72, PIXART_STEPS * PIXART_DEPTH))
# the "dit_ring" run's chunks: one rank's 2048 queries against one rank's 2048
# keys, the own chunk and one hop a block and step at sp 2; the "dit_usp"
# run's at sp 4, ulysses_degree 2 (CFG folded): a pair's 2048 tokens on 8
# heads against the same of each of the ring's two assemblies
PIXART_RING_HOPS = (("dit_ring_hop" + PIXART, 1, 2048, 2048, 16, 72,
                     2 * PIXART_STEPS * PIXART_DEPTH),
                    ("dit_usp_chunk" + PIXART, 2, 2048, 2048, 8, 72,
                     2 * PIXART_STEPS * PIXART_DEPTH))
# PipeFusion at 1024x1024, 4 chunks of 1024 tokens, warmup 1 of 4 steps
# (2 mega-patch passes and 8 chunk passes a stage): a chunk's queries
# against a block's whole cache, K and V strided views of its fused [B,
# 4096, 2C] rows; B = 2 with the CFG folded (the one-card call, 28 blocks;
# the "pipefusion" run, 7 a rank), B = 1 under the CFG split
# ("pipefusion_cfg", 14 blocks a rank, its mega-patch passes at B = 1 too)
PIPEFUSION_PATCHES = 4
PIXART_TOKENS, PIXART_HIDDEN = 4096, 1152  # PixArt-α 1024x1024: 64 x 64 tokens of 1152
# the step drive's dispatches (``step_drive`` in pixart_phase / sd3_phase):
# every dispatch, solo or packed, at the executor's width 2 with the CFG
# folded; launches a row are per evaluation
STEP_DIT_SHAPE = ("step_dit_self" + PIXART, 4, 4096, 4096, 16, 72, PIXART_DEPTH)
PIPEFUSION_SHAPES = (
    ("pipefusion_chunk" + PIXART, 2, 1024, 4096, 16, 72, 8 * PIXART_DEPTH),
    ("pipefusion_chunk_cfg" + PIXART, 1, 1024, 4096, 16, 72, 8 * PIXART_DEPTH // 2),
    ("pipefusion_warm_cfg" + PIXART, 1, 4096, 4096, 16, 72, 2 * PIXART_DEPTH // 2))
KNOB_RUNS = ("ring", "compress_pcpp", "stepcache_batch")
# the ring attention's chunk shapes at CFG 2 x sp 2 (B = 1, L / 2 queries
# against one rank's L / 2 keys), as the flash kernel's log-sum-exp
# instances see them: SDXL's level 1 and level 2 (mid) self-attention
RING_HOPS = (("ring_hop_l1", 1, 2048, 2048, 10, 64), ("ring_hop_l2", 1, 512, 512, 20, 64))
# the sequence-parallel decode's ring (models/vae.py decode_sp), as the d = 512
# log-sum-exp instance sees it: one rank's L/n queries against one rank's L/n
# keys of the VAE mid attention, n launches a decode; (name, B, Lq, Lk, H, d,
# launches a decode): the multi-rank runs' 1024x1024 SDXL and 512x512 SD 1.5
# decodes at sp 2 (the serve_ranks run's of two images at once, B = 2), and
# the 2048x2048 decode at sp 2 and sp 4
VAE_RING_HOPS = (("vae_ring_1024_sp2", 1, 8192, 8192, 1, 512, 2),
                 ("vae_ring_1024_sp2" + SERVE_RANKS, 2, 8192, 8192, 1, 512, 2),
                 ("vae_ring_512_sp2" + SD15, 1, 2048, 2048, 1, 512, 2),
                 ("vae_ring_2048_sp2", 1, 32768, 32768, 1, 512, 2),
                 ("vae_ring_2048_sp4", 1, 16384, 16384, 1, 512, 4))
# the 2048x2048 sequence-parallel decode at world 4: sp 4, and CFG 2 x sp 2
DECODE_SP_LAYOUTS = (("sp4", {"split_batch": False}), ("cfg2_sp2", {}))
# the bf16 sequence-parallel decode's relative L2 against a float32 whole
# decode may exceed the bf16 whole decode's by this factor at most
DECODE_SP_NOISE_MARGIN = 1.05
PROMPT2 = "a watercolor of a lighthouse on a cliff at dawn"
# the prompts of each multi-rank run's calls (default: PROMPT)
RUN_PROMPTS = {"dp": [PROMPT, PROMPT2]}
# img2img at 1024x1024: strength 0.5 of 4 steps runs steps 2 and 3; the
# multi-rank run's 0.75 runs steps 1-3 (2 synchronous, 1 stale at warmup 1)
I2I_STEPS, I2I_STRENGTH, PATCH_I2I_STRENGTH = 4, 0.5, 0.75
HANDOFF_AT = 0.5  # denoising_end of the base call, denoising_start of the next
REFINER_PROJ = 1280 + 5 * 256  # pooled bigG + 5 time ids of 256: the refiner layout
DECODE_SIZE, DECODE_TILE = 2048, 64  # the row-tiled decode above 1024 px
COLLECTIVES = "collectives (nccl)"
QUANT_ENTRY = {"name": "quantize_rows", "route": "cuda",
               "source": "distrifuser_tpu_torch/csrc/quantize_rows.cu",
               "replaces": "distrifuser_tpu/parallel/compress.py:111"}
DEQUANT_ENTRY = {"name": "dequantize_rows", "route": "cuda",
                 "source": "distrifuser_tpu_torch/csrc/dequantize_rows.cu",
                 "replaces": "distrifuser_tpu/parallel/compress.py:142"}
FLASH_ENTRY = {"name": "flash_sdpa", "route": "cuda",
               "source": "distrifuser_tpu_torch/csrc/flash_attention.cu",
               "replaces": "distrifuser_tpu/ops/flash_attention.py:41"}
TINY_PIXART_HEADS = 2  # the tiny DiT's 144 columns as 2 heads of PixArt's d = 72
# SD3 at 1024x1024: each joint attention runs over the 154 context tokens
# (77 CLIP + max_t5_tokens 77) and the 4096 image tokens, 4 flow-euler steps
SD3_STEPS, SD3_CONTEXT, SD3_T5_TOKENS = 4, 154, 77
TINY_SD3_HEADS, TINY_SD3_T5_TOKENS = 2, 7  # the tiny MMDiT: 2 heads of SD3's d = 64
# SD3-medium's joint attention in the step drive: 154 context + 4096 image
# tokens, 24 heads of 64, B = 4; launches per evaluation (24 joint blocks)
STEP_MMDIT_SHAPE = ("step_mmdit_joint" + SD3, 4, SD3_CONTEXT + 4096, SD3_CONTEXT + 4096,
                    24, 64, 24)
# the published stabilityai/stable-diffusion-3-medium vae/config.json (the
# fields vae_config_from_json reads, and the two use_*_quant_conv keys: false
# there, SD3's VAE has no 1x1 quant convs, and the port's reader takes them:
# this VAE has neither conv, and its decode and encode run none)
SD3_VAE_JSON = {"in_channels": 3, "out_channels": 3, "latent_channels": 16,
                "block_out_channels": [128, 256, 512, 512], "layers_per_block": 2,
                "norm_num_groups": 32, "scaling_factor": 1.5305, "shift_factor": 0.0609,
                "use_quant_conv": False, "use_post_quant_conv": False}
# the published stabilityai/stable-diffusion-3.5-medium transformer/config.json
SD35M_JSON = {"sample_size": 128, "patch_size": 2, "in_channels": 16, "out_channels": 16,
              "num_layers": 24, "attention_head_dim": 64, "num_attention_heads": 24,
              "joint_attention_dim": 4096, "caption_projection_dim": 1536,
              "pooled_projection_dim": 2048, "pos_embed_max_size": 384,
              "qk_norm": "rms_norm", "dual_attention_layers": list(range(13))}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, target_ms=200.0, max_iters=50):
    """Mean ms per call over a CUDA-event-timed run after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = max(3, min(max_iters, math.ceil(target_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, attempts=3):
    """Mean device time per call: the CUDA kernels' own time under
    torch.profiler over ``iters`` calls after one warm-up, without the host
    gaps that back-to-back timing of a short kernel includes.  A session
    that recorded no device time is taken again; None if every one of
    ``attempts`` sessions came back empty (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if total_us > 0:
            return total_us / iters / 1e3
    return None


def attention_shapes(ucfg, vcfg, height, width, unet_evals, suffix="", batch=1):
    """Every (B, Lq, Lk, heads, d) the main path gives the kernel, with its
    launch count for one pipeline call of ``batch`` images: per UNet level a
    self- and a cross-attention for each transformer block (CFG folds B to
    2 x batch), and the VAE's single-head mid attention at the latent
    resolution (B = batch: the decode takes a batch_size chunk at once).
    ``suffix`` marks another model family's rows (or the serve phase's)."""
    from distrifuser_tpu_torch.models.unet import transformer_blocks_per_level

    blocks = transformer_blocks_per_level(ucfg)
    lh, lw = height // 8, width // 8
    shapes = []
    for lvl, count in enumerate(blocks):
        if not count:
            continue
        tokens = (lh >> lvl) * (lw >> lvl)
        heads = ucfg.num_attention_heads[lvl]
        d = ucfg.block_out_channels[lvl] // heads
        shapes.append((f"unet_self_l{lvl}{suffix}", 2 * batch, tokens, tokens, heads, d,
                       count * unet_evals))
        shapes.append((f"unet_cross_l{lvl}{suffix}", 2 * batch, tokens, TEXT_LEN, heads, d,
                       count * unet_evals))
    top = vcfg.block_out_channels[-1]
    shapes.append((f"vae_mid{suffix}", batch, lh * lw, lh * lw, 1, top, 1))
    return shapes


def family(name: str) -> str:
    """The model family of a kernel-phase row by its shape name."""
    for fam, suffix in (("sd15", SD15), ("sd21", SD21), ("pixart", PIXART), ("sd3", SD3),
                        ("serve", SERVE), ("serve_ranks", SERVE_RANKS)):
        if name.endswith(suffix):
            return fam
    return "sdxl"


def patch_attention_shapes(shapes, n, batch):
    """The shapes of ``attention_shapes`` on one rank of the patch path at
    n patches and ``batch`` rows per rank (1 under the CFG split with one
    prompt, 2 without it): each UNet attention takes this rank's L/n
    queries, self-attention against all L gathered keys, cross-attention
    against the text; the VAE row is left as it is (the sequence-parallel
    decode's are ``VAE_RING_HOPS``)."""
    out = []
    for name, b, lq, lk, heads, d, calls in shapes:
        if name.startswith("unet"):
            name, b, lq = "patch_" + name, batch, lq // n
        out.append((name, b, lq, lk, heads, d, calls))
    return out


def naive_attention_shapes(shapes, n, batch):
    """The shapes of ``attention_shapes`` on one rank of naive patch
    parallelism: the dense UNet on L/n tokens of a slice (``batch`` rows per
    rank), self-attention at Lq = Lk = L/n; the VAE row unchanged."""
    out = []
    for name, b, lq, lk, heads, d, calls in shapes:
        if name.startswith("unet"):
            name, b = "naive_" + name, batch
            lk = lk // n if "self" in name else lk
            lq //= n
        out.append((name, b, lq, lk, heads, d, calls))
    return out


def tp_attention_shapes(shapes, n, batch):
    """The shapes of ``attention_shapes`` on one rank of tensor parallelism
    at n ranks: every token, this rank's ceil(heads / n) heads (the head
    count zero-padded to a multiple of n); the VAE row unchanged."""
    out = []
    for name, b, lq, lk, heads, d, calls in shapes:
        if name.startswith("unet"):
            name, b, heads = f"tp{n}_" + name, batch, -(-heads // n)
        out.append((name, b, lq, lk, heads, d, calls))
    return out


def tp_layout(cards):
    """(world, n) of the tensor-parallel run: one card a rank on four
    cards (tp 4, SDXL's 10 heads padded to 12); two ranks staged through
    the host on one card (tp 2), to bound the staged all-reduces."""
    return (4, 4) if cards >= PATCH_WORLD else (2, 2)


def sd3_attention_shapes(steps=SD3_STEPS, n=PATCH_WORLD // 2):
    """The flash kernel's shapes on SD3's path with their launches, derived
    from the configs: the joint attention of the dense 1024x1024 call (CFG
    folded, B = 2: 154 context + 4096 image tokens against as many), one
    "sd3" rank at CFG 2 x sp 2 (154 + 4096/n queries against every key),
    the SD3 VAE's mid attention (one decode), and SD3.5-medium's image-only
    dual attention (launches of one evaluation: its 13 dual blocks); and
    the "sd3_ring" rank's log-sum-exp chunks: the 154 + 4096/n queries
    against one rank's 4096/n image keys (the own chunk and one hop a block
    and step) and against the 154 context keys (the static block)."""
    from distrifuser_tpu_torch.models import mmdit, vae

    m, m35 = mmdit.sd3_config(), mmdit.mmdit_config_from_json(SD35M_JSON)
    lx, lc, heads, d = m.num_tokens, SD3_CONTEXT, m.num_heads, m.head_dim
    calls, latent = steps * m.depth, m.sample_size ** 2
    top = vae.vae_config_from_json(SD3_VAE_JSON).block_out_channels[-1]
    plain = [("mmdit_joint" + SD3, 2, lc + lx, lc + lx, heads, d, calls),
             ("patch_mmdit_joint" + SD3, 1, lc + lx // n, lc + lx, heads, d, calls),
             ("vae_mid" + SD3, 1, latent, latent, 1, top, 1),
             ("mmdit35m_dual" + SD3, 2, lx, lx, m35.num_heads, m35.head_dim,
              m35.dual_attention_blocks)]
    lse = [("sd3_ring_chunk" + SD3, 1, lc + lx // n, lx // n, heads, d, 2 * calls),
           ("sd3_ring_static" + SD3, 1, lc + lx // n, lc, heads, d, calls)]
    return plain, lse


def refresh_layers(ucfg, shallow_depth=0):
    """(self-attention layers, 3x3 halo convs) one evaluation of the patch
    path refreshes in a stale step: the whole UNet, or with
    ``shallow_depth`` K the shallow part a shallow step of the step cache
    runs (down blocks before L - K without the last one's downsampler, up
    blocks from K on, conv_out)."""
    levels, lpb = len(ucfg.block_out_channels), ucfg.layers_per_block
    cut = levels - shallow_depth
    attn = halos = 0
    for i, btype in enumerate(ucfg.down_block_types):
        if i >= cut:
            break
        halos += 2 * lpb
        if btype == "CrossAttnDownBlock2D":
            attn += lpb * ucfg.transformer_layers_per_block[i]
        if i < levels - 1 and not (shallow_depth and i == cut - 1):
            halos += 1
    if not shallow_depth:
        halos += 4
        attn += ucfg.transformer_layers_per_block[-1]
    for i, btype in enumerate(ucfg.up_block_types):
        if i < shallow_depth:
            continue
        halos += 2 * (lpb + 1)
        if btype == "CrossAttnUpBlock2D":
            attn += (lpb + 1) * ucfg.transformer_layers_per_block[levels - 1 - i]
        if i < levels - 1:
            halos += 1
    return attn, halos + 1  # conv_out


def refresh_sources(ucfg, height, width, n, batch, shallow_depth=0):
    """The payloads one stale evaluation of the patch path codes under
    ``comm_compress``, one codec segment each: per self-attention layer
    its KV [batch, L/n, 2C] ("kv"), per 3x3 halo conv its input activation
    [batch, h/n, W, C] ("halo": the two boundary slabs, halo 1, read in
    place); the shallow part only with ``shallow_depth``.  Returns
    {(kind, shape): count}."""
    levels, lpb = len(ucfg.block_out_channels), ucfg.layers_per_block
    boc = ucfg.block_out_channels
    lh, lw = height // 8, width // 8
    cut = levels - shallow_depth
    out = {}

    def add(key, count=1):
        out[key] = out.get(key, 0) + count

    def halo(level, ch):
        add(("halo", (batch, (lh >> level) // n, lw >> level, ch)))

    def attn(level, count):
        if count:
            add(("kv", (batch, (lh >> level) * (lw >> level) // n, 2 * boc[level])), count)

    for i, btype in enumerate(ucfg.down_block_types):
        if i >= cut:
            break
        for j in range(lpb):
            halo(i, boc[max(i - 1, 0)] if j == 0 else boc[i])
            halo(i, boc[i])
        if btype == "CrossAttnDownBlock2D":
            attn(i, lpb * ucfg.transformer_layers_per_block[i])
        if i < levels - 1 and not (shallow_depth and i == cut - 1):
            halo(i, boc[i])
    if not shallow_depth:
        for _ in range(4):
            halo(levels - 1, boc[-1])
        attn(levels - 1, ucfg.transformer_layers_per_block[-1])
    rev = list(reversed(boc))
    for i, btype in enumerate(ucfg.up_block_types):
        level = levels - 1 - i
        out_ch, in_ch = rev[i], rev[min(i + 1, levels - 1)]
        prev_out = rev[max(i - 1, 0)]
        if i < shallow_depth:
            continue
        for j in range(lpb + 1):
            res_in = prev_out if j == 0 else out_ch
            skip = in_ch if j == lpb else out_ch
            halo(level, res_in + skip)
            halo(level, out_ch)
        if btype == "CrossAttnUpBlock2D":
            attn(level, (lpb + 1) * ucfg.transformer_layers_per_block[level])
        if i < levels - 1:
            halo(level - 1, out_ch)
    halo(0, boc[0])  # conv_out
    return out


def decode_launches(fields, model):
    """(plain, log-sum-exp) flash launches of one decode of a multi-rank
    run at PATCH_WORLD with config ``fields``: n of the d = 512 log-sum-exp
    instance where the pipeline decodes sequence-parallel over n ranks
    (``decoder_choice``: the image in patches, ``vae_sp`` on, the latent
    rows divide), else one of the plain instance (a whole decode)."""
    group = PATCH_WORLD // fields.get("dp_degree", 1)
    n = group // 2 if fields.get("split_batch", True) else group
    sp = (fields.get("parallelism", "patch") in ("patch", "naive_patch") and n > 1
          and fields.get("vae_sp", True) and (SIZES[model] // 8) % n == 0)
    return (0, n) if sp else (1, 0)


def multi_expected(label, ucfg):
    """The launches one call of the multi-rank run ``label`` makes on one
    rank: the comm-knob runs' (``knob_expected``), the DiT's self-attention
    or the MMDiT's joint attention at every block and step (ring: the own
    chunk, the MMDiT's static context block and one hop, log-sum-exp), else
    the UNet's attentions at every step; and the decode's
    (``decode_launches``)."""
    fields, _, _, model, steps = MULTI_RUNS[label]
    if label in KNOB_RUNS:
        return knob_expected(label, ucfg)
    if label in DIT_RUNS + SD3_RUNS:  # ucfg: the DiT's or the MMDiT's
        return transformer_expected(label, ucfg)
    plain, lse = decode_launches(fields, model)
    from distrifuser_tpu_torch.models import unet

    return {"flash_sdpa": steps * unet.attention_calls_per_forward(ucfg) + plain + lse,
            "flash_sdpa_lse": lse, "quant_matmul": 0, "quantize_rows": 0}


def transformer_expected(label, mcfg):
    """The launches one call of the transformer run ``label`` (DIT_RUNS,
    SD3_RUNS) makes on one rank, from the DiT's or MMDiT's config ``mcfg``:
    one attention a block and evaluated step (a shallow step of the step
    cache runs the first depth - step_cache_depth blocks, and the dual
    prefix), each the plain flash instance once ("gather", "ulysses") or
    the log-sum-exp one once a chunk ("ring": the own chunk, the MMDiT's
    static context block and one hop a peer; "usp": the own assembly and
    one hop a peer of the ring group); the refresh codec's encoder and
    decoder once a compressed payload in every stale and shallow step; two
    all-to-alls an attention under ulysses, and under usp with
    ``ulysses_degree`` > 1; and the decode's (``decode_launches``)."""
    from distrifuser_tpu_torch.parallel.stepcache import phase_step_counts

    fields, _, _, model, steps = MULTI_RUNS[label]
    counts = phase_step_counts(steps, fields["warmup_steps"],
                               fields.get("step_cache_interval", 1))
    dual = getattr(mcfg, "dual_attention_blocks", 0)
    per_full = mcfg.depth + dual
    per_shallow = mcfg.depth - fields.get("step_cache_depth", 0) + dual
    attn = (counts["sync"] + counts["stale"]) * per_full + counts["shallow"] * per_shallow
    refreshed = counts["stale"] * per_full + counts["shallow"] * per_shallow
    n = PATCH_WORLD // fields.get("dp_degree", 1)
    n = n // 2 if fields.get("split_batch", True) else n
    impl = fields.get("attn_impl", "gather")
    u = fields.get("ulysses_degree", 1)
    chunks = {"ring": n + (model == "sd3"), "usp": n // u}.get(impl, 0)
    plain, lse = decode_launches(fields, model)
    codec = refreshed if fields.get("comm_compress", "none") != "none" else 0
    a2a = 2 * attn if impl == "ulysses" or (impl == "usp" and u > 1) else 0
    return {"flash_sdpa": attn * max(chunks, 1) + plain + lse,
            "flash_sdpa_lse": attn * chunks + lse, "quant_matmul": 0,
            "quantize_rows": codec, "dequantize_rows": codec, "all_to_all": a2a}


def knob_expected(label, ucfg):
    """``knob_counts`` of the comm-knob run ``label``."""
    fields, _, _, _, steps = MULTI_RUNS[label]
    return knob_counts(fields, steps, ucfg, label)


def knob_counts(fields, steps, ucfg, label=""):
    """The launches one call of the patch path with the comm knobs
    ``fields`` makes on one rank at CFG 2 x sp 2: flash (a ring
    self-attention launches the log-sum-exp instance once per chunk, n = 2;
    a shallow step runs only the shallow levels' attention; the decode
    ``decode_launches``), its log-sum-exp instances, and the refresh codec's
    encode (quantize_rows) and decode (dequantize_rows) kernels in every
    stale or shallow step: one launch of each per compressed KV or halo
    payload, or under ``comm_batch`` one of each per flush (per CODEC_TABLE
    segments)."""
    from distrifuser_tpu_torch.models import unet
    from distrifuser_tpu_torch.parallel.stepcache import phase_step_counts

    n = 2
    counts = phase_step_counts(steps, fields["warmup_steps"],
                               fields.get("step_cache_interval", 1))
    attn, halos = refresh_layers(ucfg)
    depth = fields.get("step_cache_depth", 0)
    attn_s, halos_s = refresh_layers(ucfg, depth) if depth else (0, 0)
    for d, want in [(0, attn + halos)] + ([(depth, attn_s + halos_s)] if depth else []):
        got = sum(refresh_sources(ucfg, 1024, 1024, n, 1, d).values())
        assert got == want, (label, d, got, want)
    full_steps = counts["sync"] + counts["stale"]
    ring = fields.get("attn_impl") == "ring"
    per_full = unet.attention_calls_per_forward(ucfg) + (n - 1) * attn * ring
    plain, lse = decode_launches(fields, "sdxl")
    flash = full_steps * per_full + counts["shallow"] * 2 * attn_s + plain + lse
    codec = 0
    if fields.get("comm_compress", "none") != "none":
        per_step = ((lambda p: -(-p // CODEC_TABLE)) if fields.get("comm_batch")
                    else (lambda p: p))
        codec = counts["stale"] * per_step(attn + halos)
        if counts["shallow"]:
            codec += counts["shallow"] * per_step(attn_s + halos_s)
    return {"flash_sdpa": flash, "quant_matmul": 0, "quantize_rows": codec,
            "dequantize_rows": codec,
            "flash_sdpa_lse": (full_steps * n * attn if ring else 0) + lse}


def refresh_codec_rows(ucfg, height, width):
    """The rows of the refresh-codec phase, with their launches per call of
    one rank: every compress_pcpp payload (int8, k = 2, one encode and one
    decode launch each in every stale step) by source shape, and the
    stepcache_batch flush tables (fp8, every payload of a step in one
    grouped launch of each kernel): the stale step's and the shallow
    step's; the transformer runs' KV and the serve_ranks tier's payloads
    (``transformer_codec_rows``, ``serve_ranks_codec_rows``)."""
    from distrifuser_tpu_torch.parallel.stepcache import phase_step_counts

    rows = []
    fields, _, _, _, steps = MULTI_RUNS["compress_pcpp"]
    counts = phase_step_counts(steps, fields["warmup_steps"], 1)
    k = round(1 / fields["refresh_fraction"])
    for (kind, shape), c in sorted(refresh_sources(ucfg, height, width, 2, 1).items()):
        rows.append({"shape": f"refresh_compress_pcpp_{kind}_{'x'.join(map(str, shape))}",
                     "mode": "int8", "k": k, "sources": [(kind, shape)],
                     "launches_per_call": c * counts["stale"]})
    fields, _, _, _, steps = MULTI_RUNS["stepcache_batch"]
    counts = phase_step_counts(steps, fields["warmup_steps"], fields["step_cache_interval"])
    for phase, depth in (("stale", 0), ("shallow", fields["step_cache_depth"])):
        sources = [key for key, c in sorted(refresh_sources(ucfg, height, width, 2, 1,
                                                            depth).items())
                   for _ in range(c)]
        rows.append({"shape": f"refresh_stepcache_batch_{phase}_table", "mode": "fp8",
                     "k": 1, "sources": sources,
                     "launches_per_call": counts[phase] * -(-len(sources) // CODEC_TABLE)})
    return rows + transformer_codec_rows() + serve_ranks_codec_rows(ucfg, height, width)


def serve_ranks_tier():
    """The DistriConfig knobs of the SLO controller's SERVE_RANKS_TIER tier
    on a patch key (serve/controller.py ``DEFAULT_TIERS``, ``apply_tier``)."""
    from distrifuser_tpu_torch.serve import DEFAULT_TIERS

    tier = next(t for t in DEFAULT_TIERS if t.name == SERVE_RANKS_TIER)
    knobs = {"comm_compress": tier.comm_compress or "none"}
    if tier.step_cache is not None:
        knobs["step_cache_interval"], knobs["step_cache_depth"] = tier.step_cache
    if tier.refresh_fraction is not None:
        knobs["refresh_fraction"] = tier.refresh_fraction
    return knobs


def serve_ranks_codec_rows(ucfg, height, width):
    """The refresh payloads of one serve_ranks dispatch at the
    SERVE_RANKS_TIER tier, one rank's (2 rows of one branch at CFG 2 x sp
    2), one encode and one decode launch each in every stale step (the
    whole UNet's) and shallow step (its shallow part's)."""
    from distrifuser_tpu_torch.parallel.stepcache import phase_step_counts

    knobs = serve_ranks_tier()
    counts = phase_step_counts(PATCH_STEPS, PATCH_WARMUP, knobs["step_cache_interval"])
    by_source = {}
    for phase, depth in (("stale", 0), ("shallow", knobs["step_cache_depth"])):
        for key, c in refresh_sources(ucfg, height, width, 2, SERVE_BATCH, depth).items():
            by_source[key] = by_source.get(key, 0) + c * counts[phase]
    return [{"shape": f"refresh_serve_ranks_{kind}_{'x'.join(map(str, shape))}",
             "mode": knobs["comm_compress"],
             "k": round(1 / knobs.get("refresh_fraction", 1.0)),
             "sources": [(kind, shape)], "launches_per_call": c}
            for (kind, shape), c in sorted(by_source.items())]


def transformer_codec_rows():
    """The refresh-codec rows of the transformer knob runs
    (TRANSFORMER_KNOB_RUNS, int8, k = 2): one rank's fused KV [1, N/2,
    2·hidden] of a block at CFG 2 x sp 2, coded with one scale per row of k
    and one per row of v ("kv2": the two column halves read in place as the
    parts of one segment, decoded as two segments of one launch), one
    launch of each kernel a block in every stale step and a block before
    the cut in every shallow one; also checked with the residual base."""
    from distrifuser_tpu_torch.parallel.stepcache import phase_step_counts

    rows = []
    for label in TRANSFORMER_KNOB_RUNS:
        fields, _, _, model, steps = MULTI_RUNS[label]
        mcfg = model_configs(model)[0]
        counts = phase_step_counts(steps, fields["warmup_steps"],
                                   fields["step_cache_interval"])
        shape = (1, mcfg.num_tokens // 2, 2 * mcfg.hidden_size)
        payloads = (counts["stale"] * mcfg.depth
                    + counts["shallow"] * (mcfg.depth - fields["step_cache_depth"]))
        rows.append({"shape": f"refresh_{label}_kv2_{'x'.join(map(str, shape))}",
                     "mode": fields["comm_compress"],
                     "k": round(1 / fields["refresh_fraction"]),
                     "sources": [("kv2", shape)], "launches_per_call": payloads,
                     "residual_check": True})
    return rows


def _codec_segments(sources, k, residual, seed):
    """Encode and decode segments of the refresh codec as the patch context
    builds them for ``sources`` (``refresh_sources`` keys, or "kv2": a
    transformer's fused KV [B, L/n, 2C] whose k and v halves are the two
    parts of one segment, decoded as two segments): bf16 sources
    read in place (a KV [B, L/n, 2C]; a halo's two boundary slabs of its
    [B, h/n, W, C] activation), the rotation r = 1 a device scalar when
    k > 1, the residual base (the previous slot or the own rows) when
    ``residual``; decoded as the peers' payloads arrive (KV: both ranks'
    payloads, gathered; halo: the two halves, each in its own buffer) into
    a new buffer beside a seeded previous one."""
    import torch

    from distrifuser_tpu_torch.ops import quantize as qz
    from distrifuser_tpu_torch.parallel.context import _half, _halo_slabs, _halves

    g = torch.Generator(device="cuda").manual_seed(seed)
    every = (k, torch.tensor(1, device="cuda")) if k > 1 else None

    def rows(*shape):
        x = torch.randn(*shape, device="cuda", generator=g).bfloat16()
        x.view(-1, shape[-1])[0] = 0
        return x

    enc, prevs = [], []
    for kind, shape in sources:
        if kind == "kv2":  # the k and v halves as the parts of one view
            x = _halves(rows(*shape), 2)
            base = _halves(rows(*shape), 2) if residual else None
        else:
            x = rows(*shape) if kind == "kv" else _halo_slabs(rows(*shape), 1)
            base = rows(*x.shape) if residual else None
        enc.append(qz.EncodeSeg(x, base, every))
        prevs.append(rows(2, *shape) if kind in ("kv", "kv2") else rows(*x.shape))

    def decode_segs(coded):
        segs = []
        for (kind, _), (q, s), prev in zip(sources, coded, prevs):
            if kind == "kv2":  # both ranks' payloads, each half into its buffer
                q, s = torch.stack([q, q]), torch.stack([s, s])
                segs += [qz.DecodeSeg(q[:, h], s[:, h],
                                      _half(prev, h, 2) if residual else None,
                                      _half(prev, h, 2) if every is not None else None,
                                      every) for h in range(2)]
                continue
            if kind == "kv":  # [n, ...]: both ranks' payloads
                q, s = torch.stack([q, q]), torch.stack([s, s])
            else:  # from the previous rank (its bottom) and the next (its top)
                q, s = [q[1].clone(), q[0].clone()], [s[1].clone(), s[0].clone()]
            segs.append(qz.DecodeSeg(q, s, prev if residual else None,
                                     prev if every is not None else None, every))
        return segs

    return enc, decode_segs


def _codec_bytes(sources, k, residual):
    """(encode, decode) bytes the codec must move for ``sources``: the
    encoder reads the selected source rows (bf16) and the base and writes
    one byte an element and a float32 scale a row; the decoder reads the
    payloads and scales of both parts, the base, the previous buffer's kept
    rows, and writes the whole buffer of both parts (bf16)."""
    enc = dec = 0.0
    for kind, shape in sources:
        cols = shape[-1] // (2 if kind == "kv2" else 1)  # kv2: a row a half
        full = math.prod(shape[:-1]) * {"kv": 1, "kv2": 2}.get(kind, 2 / shape[1])
        sel = full / k
        enc += sel * cols * (2 + (2 if residual else 0) + 1) + 4 * sel
        parts = 2 if kind in ("kv", "kv2") else 1  # a KV buffer holds both ranks' rows
        dec += parts * (sel * cols * (1 + (2 if residual else 0)) + 4 * sel
                        + 2 * (full - sel) * cols + 2 * full * cols)
    return enc, dec


def refresh_codec_phase(rows):
    """Both codec kernels at the knob runs' refresh payloads
    (``refresh_codec_rows``), fed as the context feeds them
    (``_codec_segments``): the encoder and the decoder bit for bit with
    their plain versions (quantize_rows_reference, dequantize_rows_reference),
    per payload (compress_pcpp) and as one grouped launch over a step's
    table (stepcache_batch, whose tables are also checked with the residual
    base), then timed by CUDA events and device time beside the plain
    version; bound by bytes.  No library call computes either."""
    import torch

    from distrifuser_tpu_torch.ops import quantize as qz

    def same(a, b):
        return a.shape == b.shape and torch.equal(a.contiguous().view(torch.uint8),
                                                  b.contiguous().view(torch.uint8))

    results = []
    for i, row in enumerate(rows):
        mode, k, sources = row["mode"], row["k"], row["sources"]
        checks = [False, True] if len(sources) > 1 or row.get("residual_check") else [False]
        for residual in checks:
            enc, decode_segs = _codec_segments(sources, k, residual, seed=i)
            payload = "int8" if residual else mode
            coded = qz.quantize_rows_grouped(enc, payload)
            for seg, (q, s) in zip(enc, coded):
                wq, ws = qz.quantize_rows_reference(seg, payload)
                if not (same(q, wq) and same(s, ws)):
                    raise AssertionError(f"quantize_rows {row['shape']} residual={residual} "
                                         f"{tuple(seg.x.shape)}: not bit-identical")
            dec = decode_segs(coded)
            for seg, buf in zip(dec, qz.dequantize_rows_grouped(dec, torch.bfloat16)):
                if not same(buf, qz.dequantize_rows_reference(seg, torch.bfloat16)):
                    raise AssertionError(f"dequantize_rows {row['shape']} residual="
                                         f"{residual}: not bit-identical")
        enc, decode_segs = _codec_segments(sources, k, False, seed=i)
        dec = decode_segs(qz.quantize_rows_grouped(enc, mode))
        fns = {"quantize_": lambda: qz.quantize_rows_grouped(enc, mode),
               "dequantize_": lambda: qz.dequantize_rows_grouped(dec, torch.bfloat16)}
        plains = {"quantize_": lambda: [qz.quantize_rows_reference(e, mode) for e in enc],
                  "dequantize_": lambda: [qz.dequantize_rows_reference(d, torch.bfloat16)
                                          for d in dec]}
        nbytes = dict(zip(fns, _codec_bytes(sources, k, False)))
        line = {"shape": row["shape"], "mode": mode, "k": k, "segments": len(sources),
                "launches_per_call": row["launches_per_call"]}
        for prefix, fn in fns.items():
            bound, by = _bound(0.0, nbytes[prefix])
            line.update({prefix + "max_abs_err": 0.0,
                         prefix + "ms": time_ms(fn, target_ms=QUANT_TARGET_MS),
                         prefix + "device_ms": device_ms(fn, iters=20, attempts=5),
                         prefix + "plain_ms": time_ms(plains[prefix], target_ms=QUANT_TARGET_MS,
                                                      max_iters=5),
                         prefix + "library_ms": None, prefix + "library_device_ms": None,
                         prefix + "bound_ms": bound, prefix + "bound_by": by})
        print(json.dumps(line), flush=True)
        results.append(line)
        del enc, dec, fns, plains
        torch.cuda.empty_cache()
    return results


def hop_codec_phase():
    """Both codec kernels at PipeFusion's hop (parallel/pipefusion.py): one
    chunk [2, 1024, 1152] of the "pipefusion_knobs" run (sp 4, CFG folded,
    4 chunks) coded with one float32 scale per token row, as the runner
    codes it: int8 and fp8 from the bf16 chunk, decoded to bf16; and the
    residual code (int8) of the float32 chunk against a float32 predictor,
    decoded onto the predictor in float32 (the sender's reconstruction and
    the receiver's decode).  Each bit for bit with its plain version, timed
    beside it; bound by bytes; launches a call of one rank of the run: one
    encode an item sent, one decode an item received and one for the
    residual's reconstruction."""
    import torch

    from distrifuser_tpu_torch.ops import quantize as qz

    fields, _, _, _, steps = MULTI_RUNS["pipefusion_knobs"]
    _, launches = pipefusion_counts(fields, steps, PATCH_WORLD, 0)
    shape = (2, PIXART_TOKENS // PIPEFUSION_PATCHES, PIXART_HIDDEN)
    g = torch.Generator(device="cuda").manual_seed(5)
    results = []
    for mode, residual in (("int8", False), ("fp8", False), ("int8", True)):
        src = torch.randn(shape, device="cuda", generator=g)
        src = src if residual else src.bfloat16()
        base = torch.randn(shape, device="cuda", generator=g) if residual else None
        out_dtype = torch.float32 if residual else torch.bfloat16
        enc = [qz.EncodeSeg(src, base)]
        (q, sc), = qz.quantize_rows_grouped(enc, mode)
        wq, ws = qz.quantize_rows_reference(enc[0], mode)
        dec = [qz.DecodeSeg(q, sc, base)]
        got = qz.dequantize_rows_grouped(dec, out_dtype)[0]
        want = qz.dequantize_rows_reference(dec[0], out_dtype)
        same = [torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                for a, b in ((q, wq), (sc.view(torch.uint8), ws.view(torch.uint8)),
                             (got.view(torch.uint8), want.view(torch.uint8)))]
        name = f"hop_pipefusion_{mode}{'_residual' if residual else ''}_" \
               f"{'x'.join(map(str, shape))}"
        if not all(same):
            raise AssertionError(f"{name}: the codec kernels differ from their plain "
                                 f"versions (payload, scales, decode: {same})")
        rows, cols = math.prod(shape[:-1]), shape[-1]
        src_bytes = src.element_size()
        nbytes = {"quantize_": rows * cols * (src_bytes + (4 if residual else 0) + 1) + 4 * rows,
                  "dequantize_": rows * cols * (1 + (4 if residual else 0)
                                                + torch.empty((), dtype=out_dtype)
                                                .element_size()) + 4 * rows}
        fns = {"quantize_": lambda: qz.quantize_rows_grouped(enc, mode),
               "dequantize_": lambda: qz.dequantize_rows_grouped(dec, out_dtype)}
        plains = {"quantize_": lambda: qz.quantize_rows_reference(enc[0], mode),
                  "dequantize_": lambda: qz.dequantize_rows_reference(dec[0], out_dtype)}
        calls = {"quantize_": launches["quantize_rows"] if residual else 0,
                 "dequantize_": launches["dequantize_rows"] if residual else 0}
        line = {"shape": name, "mode": mode, "residual": residual,
                "source": str(src.dtype), "launches_per_call": calls["quantize_"],
                "dequantize_launches_per_call": calls["dequantize_"]}
        for prefix, fn in fns.items():
            bound, by = _bound(0.0, nbytes[prefix])
            line.update({prefix + "max_abs_err": 0.0,
                         prefix + "ms": time_ms(fn, target_ms=QUANT_TARGET_MS),
                         prefix + "device_ms": device_ms(fn, iters=20, attempts=5),
                         prefix + "plain_ms": time_ms(plains[prefix], target_ms=QUANT_TARGET_MS,
                                                      max_iters=5),
                         prefix + "library_ms": None, prefix + "library_device_ms": None,
                         prefix + "bound_ms": bound, prefix + "bound_by": by})
        print(json.dumps(line), flush=True)
        results.append(line)
    return results


def rel_errors(got, want):
    """(max |got - want|, mean |got - want|) over mean |want|, in float32."""
    want = want.float()
    err = (got.float() - want).abs()
    scale = want.abs().mean()
    return (err.max() / scale).item(), (err.mean() / scale).item()


def relative_check(name, got, want, cut, cut_lse_err=0.0):
    """Hold a "@sd3" row's kernel result ``got`` to the plain one ``want``
    within SD3_REL_MAX / SD3_REL_MEAN, and show that the check sees the key
    tail: ``cut``, the plain result without the last KV tile (its lse that
    far from ``want``'s: ``cut_lse_err``), must break the limits.  Returns
    the readings."""
    rmax, rmean = rel_errors(got, want)
    cmax, cmean = rel_errors(cut, want)
    if not (rmax <= SD3_REL_MAX and rmean <= SD3_REL_MEAN):
        raise AssertionError(f"flash_sdpa {name}: max |d| / mean |want| {rmax}, mean |d| / "
                             f"mean |want| {rmean} over {SD3_REL_MAX}/{SD3_REL_MEAN}")
    if cmax <= SD3_REL_MAX and cmean <= SD3_REL_MEAN and cut_lse_err <= LSE_MAX_ABS:
        raise AssertionError(f"flash_sdpa {name}: the plain result without its last KV "
                             f"tile is within the limits too ({cmax}, {cmean}): the check "
                             "cannot see the key tail")
    return {"rel_max_err": rmax, "rel_mean_err": rmean, "tail_cut_rel_max_err": cmax,
            "tail_cut_rel_mean_err": cmean}


def tail_keys(lk, block_k):
    """The keys of the last KV tile of ``lk`` keys in tiles of ``block_k``."""
    return lk % block_k or block_k


def lse_kernel_phase(spills, extra=()):
    """The flash kernel's log-sum-exp instances at the ring's chunk shapes
    (``RING_HOPS``, d = 64), the sequence-parallel decode's
    (``VAE_RING_HOPS``, d = 512) and ``extra`` (PixArt's ring,
    ``PIXART_RING_HOPS``, d = 72; SD3's, ``sd3_attention_shapes``, d = 64):
    out (float32) and lse against the plain
    version (out max |d| <= 2e-2, mean <= 2e-3; lse max |d| <= 1e-3; the
    "@sd3" rows also by ``relative_check``), timed
    by CUDA events and device time beside the plain version and the fastest
    (by device time) of the PyTorch calls that also return the log-sum-exp
    at the head dim: ``aten._scaled_dot_product_efficient_attention`` and
    ``aten._scaled_dot_product_cudnn_attention`` with ``compute_log_sumexp``
    and ``aten._scaled_dot_product_flash_attention``, the last two up to
    d = 256 (every candidate's times in ``library_candidates``); each row
    names the instance's registers and spilled bytes."""
    import torch

    from distrifuser_tpu_torch.models import unet
    from distrifuser_tpu_torch.ops import flash_attention as fa
    from distrifuser_tpu_torch.parallel.stepcache import phase_step_counts

    ucfg = unet.sdxl_config()
    blocks = unet.transformer_blocks_per_level(ucfg)
    fields, _, _, _, steps = MULTI_RUNS["ring"]
    counts = phase_step_counts(steps, fields["warmup_steps"], 1)
    full_steps = counts["sync"] + counts["stale"]
    hops = [(*hop, full_steps * 2 * blocks[int(hop[0][-1])])  # two chunks a layer at sp 2
            for hop in RING_HOPS] + list(VAE_RING_HOPS) + list(extra)
    results = []
    for name, b, lq, lk, heads, d, calls in hops:
        c = heads * d
        g = torch.Generator(device="cuda").manual_seed(100 + len(results))
        q = torch.randn(b, lq, c, device="cuda", generator=g).bfloat16()
        k, v = torch.randn(b, lk, 2 * c, device="cuda", generator=g).bfloat16().chunk(2, -1)
        rows = max(1, (1 << 28) // (b * heads * lk))  # query rows a plain chunk

        def plain():
            """The plain version, over query chunks of at most 2^28 logits."""
            parts = [fa.flash_sdpa_reference(q[:, i:i + rows], k, v, heads=heads,
                                             return_lse=True) for i in range(0, lq, rows)]
            return torch.cat([o for o, _ in parts], 1), torch.cat([s for _, s in parts], 2)

        out, lse = fa.flash_sdpa(q, k, v, heads=heads, return_lse=True)
        want, want_lse = plain()
        torch.cuda.synchronize()
        err = (out - want).abs()
        lse_err = (lse - want_lse).abs().max().item()
        max_err, mean_err = err.max().item(), err.mean().item()
        if not (max_err <= KERNEL_MAX_ABS and mean_err <= KERNEL_MEAN_ABS
                and lse_err <= LSE_MAX_ABS):
            raise AssertionError(f"flash_sdpa lse {name}: max |d| {max_err}, mean |d| "
                                 f"{mean_err}, lse max |d| {lse_err}")
        relative = {}
        if name.endswith(SD3):
            tail = tail_keys(lk, fa.variant(d, lse=True)["block_k"])
            cut, cut_lse = fa.flash_sdpa_reference(q, k[:, :lk - tail], v[:, :lk - tail],
                                                   heads=heads, return_lse=True)
            relative = {"tail_keys": tail, **relative_check(
                name, out, want, cut, (cut_lse - want_lse).abs().max().item())}
            del cut, cut_lse

        def kernel():
            return fa.flash_sdpa(q, k, v, heads=heads, return_lse=True)

        qh, kh, vh = (t.unflatten(-1, (heads, d)).transpose(1, 2) for t in (q, k, v))
        aten = torch.ops.aten
        candidates = {
            "aten._scaled_dot_product_efficient_attention":
                lambda: aten._scaled_dot_product_efficient_attention(qh, kh, vh, None, True),
        }
        if d <= 256:
            candidates.update({
                "aten._scaled_dot_product_flash_attention":
                    lambda: aten._scaled_dot_product_flash_attention(qh, kh, vh),
                "aten._scaled_dot_product_cudnn_attention":
                    lambda: aten._scaled_dot_product_cudnn_attention(qh, kh, vh, None, True)})
        library_times = {}
        for library_name, library in candidates.items():
            try:
                library_times[library_name] = (time_ms(library), device_ms(library))
            except RuntimeError as e:  # no library kernel for this layout
                print(f"{library_name} unavailable at {name}: {e}", file=sys.stderr)
        if library_times:  # the faster call by device time (events where unmeasured)
            library_name = min(library_times, key=lambda n: library_times[n][1]
                               or library_times[n][0])
            library_ms, library_dev_ms = library_times[library_name]
        else:
            library_name, library_ms, library_dev_ms = "none", None, None
        flops = 4.0 * b * heads * lq * lk * d
        nbytes = 2.0 * (b * lq * c + 2 * b * lk * c) + 4.0 * (b * lq * c + b * heads * lq)
        ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        ms = time_ms(kernel)
        row = {"shape": name, "B": b, "Lq": lq, "Lk": lk, "H": heads, "d": d,
               "return_lse": True, "launches_per_call": calls, "max_abs_err": max_err,
               "mean_abs_err": mean_err, "lse_max_abs_err": lse_err, "ms": ms,
               "device_ms": device_ms(kernel),
               "plain_ms": time_ms(plain, max_iters=10),
               "library": library_name,
               "library_ms": library_ms, "library_device_ms": library_dev_ms,
               "library_candidates": {n: {"ms": t[0], "device_ms": t[1]}
                                      for n, t in library_times.items()},
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "tflops": flops / (ms * 1e-3) / 1e12, **fa.variant(d, lse=True),
               "spill_store_bytes": spills.get((d, True)), **relative}
        print(json.dumps(row), flush=True)
        results.append(row)
        del q, k, v, out, lse, want, want_lse, err
        torch.cuda.empty_cache()
    return results


def kernel_phase(shapes, spills):
    import torch
    import torch.nn.functional as F

    from distrifuser_tpu_torch.ops import flash_attention as fa
    from distrifuser_tpu_torch.ops.attention import _flatten_seq, split_kv

    results = []
    for name, b, lq, lk, heads, d, calls in shapes:
        c = heads * d
        g = torch.Generator(device="cuda").manual_seed(len(results))
        q = torch.randn(b, lq, c, device="cuda", generator=g).bfloat16()
        kv_view = None
        if "vae" in name or name.startswith(("mmdit_joint", "patch_mmdit",
                                             "step_mmdit_joint")):
            # separate to_q/to_k/to_v projections; the MMDiT's joint K and V
            # are concatenations (context rows, then image rows)
            k = torch.randn(b, lk, c, device="cuda", generator=g).bfloat16()
            v = torch.randn(b, lk, c, device="cuda", generator=g).bfloat16()
        elif name.startswith(("patch_unet_self", "patch_dit_self")):
            # the stale step's gathered KV [n, B, L/n, 2C], flattened to
            # [B, L, 2C] in patch order and split, as patch_self_attention does
            gathered = torch.randn(lk // lq, b, lq, 2 * c, device="cuda",
                                   generator=g).bfloat16()
            k, v = split_kv(_flatten_seq(gathered))
            kv_view = k.untyped_storage().data_ptr() == gathered.untyped_storage().data_ptr()
            if b == 1 and not kv_view:
                raise AssertionError(f"{name}: the flattened KV is a copy at B = 1")
        elif name.startswith("dit_ulysses_self"):
            # q, k and v of every rank's rows, this rank's heads: views of the
            # all-to-all's receive buffer [B, L, 3C] (ops/ulysses.py)
            q, k, v = torch.randn(b, lq, 3 * c, device="cuda",
                                  generator=g).bfloat16().chunk(3, -1)
        else:  # strided views of the fused to_kv output
            k, v = torch.randn(b, lk, 2 * c, device="cuda", generator=g).bfloat16().chunk(2, -1)

        def plain():
            """The plain version, over query chunks of at most 2^31 logits
            (query rows are independent)."""
            rows = max(1, (1 << 31) // (b * heads * lk))
            return torch.cat([fa.flash_sdpa_reference(q[:, i:i + rows], k, v, heads=heads)
                              for i in range(0, lq, rows)], dim=1)

        got = fa.flash_sdpa(q, k, v, heads=heads)
        want = plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        if not (max_err <= KERNEL_MAX_ABS and mean_err <= KERNEL_MEAN_ABS):
            raise AssertionError(f"flash_sdpa {name}: max |d| {max_err}, mean |d| "
                                 f"{mean_err} over {KERNEL_MAX_ABS}/{KERNEL_MEAN_ABS}")
        relative = {}
        if name.endswith(SD3):
            tail = tail_keys(lk, fa.variant(d)["block_k"])
            rows = max(1, (1 << 31) // (b * heads * lk))
            cut = torch.cat([fa.flash_sdpa_reference(q[:, i:i + rows], k[:, :lk - tail],
                                                     v[:, :lk - tail], heads=heads)
                             for i in range(0, lq, rows)], dim=1)
            relative = {"tail_keys": tail, **relative_check(name, got, want, cut)}
            del cut

        def kernel():
            return fa.flash_sdpa(q, k, v, heads=heads)

        ms = time_ms(kernel)
        t_host = time.perf_counter()  # enqueue only: the card drains afterwards
        for _ in range(HOST_CALLS):
            kernel()
        host_us = (time.perf_counter() - t_host) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
        plain_ms = time_ms(plain, max_iters=10)
        qh, kh, vh = (t.unflatten(-1, (heads, d)).transpose(1, 2) for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qh, kh, vh)

        try:
            library_ms, library_dev_ms = time_ms(library), device_ms(library)
        except RuntimeError as e:  # no library kernel for this shape
            print(f"library sdpa unavailable at {name}: {e}", file=sys.stderr)
            library_ms = library_dev_ms = None
        flops = 4.0 * b * heads * lq * lk * d
        nbytes = 2.0 * (2 * b * lq * c + 2 * b * lk * c)  # q, o; k, v
        ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {
            "shape": name, "B": b, "Lq": lq, "Lk": lk, "H": heads, "d": d,
            "launches_per_call": calls, "max_abs_err": max_err,
            "mean_abs_err": mean_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "device_ms": device_ms(kernel),
            "library_device_ms": library_dev_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "tflops": flops / (ms * 1e-3) / 1e12, "host_us_per_launch": host_us,
            **fa.variant(d),  # registers per thread, shared memory bytes, tiles
            "spill_store_bytes": spills.get((d, False)),
            **({} if kv_view is None else {"kv_view_of_gathered": kv_view}), **relative,
        }
        print(json.dumps(row), flush=True)
        results.append(row)
        del q, k, v, got, want, err
        torch.cuda.empty_cache()
    return results


def quant_shapes(ucfg, height, width, steps, batch=2, suffix=""):
    """Every (name, M, K, N, launches per pipeline call) the quantized main
    path gives the quantized-matmul kernel: per UNet level with transformer
    blocks (tokens x batch rows; CFG folds the batch to 2) the attention
    to_q / to_out and the linear proj_in / proj_out, the self-attention
    to_kv, the GEGLU projection and the FF output, once per step; the
    cross-attention to_kv on the text tokens, once per call; and the time
    and add embeddings and each resnet's time_emb_proj on ``batch`` rows.
    ``suffix`` marks another model family's rows."""
    from distrifuser_tpu_torch.models.unet import transformer_blocks_per_level

    blocks = transformer_blocks_per_level(ucfg)
    n, lpb = len(ucfg.block_out_channels), ucfg.layers_per_block
    transformers, resnets = [0] * n, [0] * n
    for i, btype in enumerate(ucfg.down_block_types):
        resnets[i] += lpb
        transformers[i] += lpb if btype == "CrossAttnDownBlock2D" else 0
    transformers[n - 1] += 1
    resnets[n - 1] += 2
    for i, btype in enumerate(ucfg.up_block_types):
        resnets[n - 1 - i] += lpb + 1
        transformers[n - 1 - i] += lpb + 1 if btype == "CrossAttnUpBlock2D" else 0
    lh, lw = height // 8, width // 8
    temb = ucfg.time_embed_dim
    shapes = []
    for lvl, nb in enumerate(blocks):
        if not nb:
            continue
        c = ucfg.block_out_channels[lvl]
        m = batch * (lh >> lvl) * (lw >> lvl)
        proj = 2 * transformers[lvl] if ucfg.use_linear_projection else 0
        shapes += [
            (f"l{lvl}_q_out_proj", m, c, c, (4 * nb + proj) * steps),
            (f"l{lvl}_self_kv", m, c, 2 * c, nb * steps),
            (f"l{lvl}_ff_in", m, c, 8 * c, nb * steps),
            (f"l{lvl}_ff_out", m, 4 * c, c, nb * steps),
            (f"l{lvl}_text_kv", batch * TEXT_LEN, ucfg.cross_attention_dim, 2 * c, nb),
        ]
    text_time = ucfg.addition_embed_type == "text_time"
    shapes.append(("time_linear_1", batch, ucfg.block_out_channels[0], temb, steps))
    shapes.append(("time_add_linear_2", batch, temb, temb, (2 if text_time else 1) * steps))
    if text_time:
        shapes.append(("add_linear_1", batch, ucfg.projection_class_embeddings_input_dim,
                       temb, steps))
    for lvl, count in enumerate(resnets):
        c = ucfg.block_out_channels[lvl]
        shapes.append((f"time_emb_proj_{c}", batch, temb, c, count * steps))
    return [(name + suffix, *rest) for name, *rest in shapes]


def pixart_quant_shapes(steps=PIXART_STEPS, batch=2, caption=120):
    """The (name, M, K, N, launches per call) of PixArt-α's quantized linears
    in a ``steps``-step 1024x1024 call at weight_quant int8 or fp8 (CFG
    folded: M = 2 x 4096 tokens): per block and step the attention q / out
    and cross q / out, the self-attention kv, the MLP's two; the caption
    path once a call; the patch embedding and the timestep and adaLN
    linears once a step (M = 1; final_out stays dense); and T5-XXL's
    linears at 2 x 120 tokens with no launches: the text encoder follows
    ``weight_quant_aux``, which densifies at the consumer."""
    from distrifuser_tpu_torch.models import dit, t5

    d, t = dit.pixart_config(), t5.t5_v1_1_xxl_config()
    h, m, mt = d.hidden_size, batch * d.num_tokens, batch * caption
    per_step = steps * d.depth
    shapes = [("dit_q_out", m, h, h, 4 * per_step), ("dit_self_kv", m, h, 2 * h, per_step),
              ("dit_mlp_fc1", m, h, d.mlp_ratio * h, per_step),
              ("dit_mlp_fc2", m, d.mlp_ratio * h, h, per_step),
              ("dit_cross_kv", mt, h, 2 * h, d.depth), ("dit_cap_fc1", mt, d.caption_dim, h, 1),
              ("dit_cap_fc2", mt, h, h, 1), ("dit_proj_in", m, d.token_dim, h, steps),
              ("dit_t_fc1", 1, d.frequency_embedding_size, h, steps),
              ("dit_t_fc2", 1, h, h, steps), ("dit_adaln", 1, h, 6 * h, steps),
              ("t5_qkvo", mt, t.d_model, t.inner_dim, 0), ("t5_wi", mt, t.d_model, t.d_ff, 0),
              ("t5_wo", mt, t.d_ff, t.d_model, 0)]
    return [(name + PIXART, *rest) for name, *rest in shapes]


def sd3_quant_shapes(steps=SD3_STEPS, batch=2):
    """The (name, M, K, N, launches per call) of SD3-medium's quantized
    linears in a ``steps``-step 1024x1024 call at weight_quant int8 or fp8
    (CFG folded: M = 2 x 4096 image rows, 2 x 154 context rows): per block
    and step both streams' fused qkv, attention out and MLP, and both
    modulations at M = 2; once a step the patch embedding, the timestep
    MLP (M = 1), the pooled-text MLP and the final modulation (M = 2); the
    context embedding once a call (final_out stays dense)."""
    from distrifuser_tpu_torch.models import mmdit

    m = mmdit.sd3_config()
    h, f = m.hidden_size, m.mlp_ratio * m.hidden_size
    mx, mc, per_step = batch * m.num_tokens, batch * SD3_CONTEXT, steps * m.depth
    shapes = [("mmdit_x_qkv", mx, h, 3 * h, per_step), ("mmdit_c_qkv", mc, h, 3 * h, per_step),
              ("mmdit_x_out", mx, h, h, per_step), ("mmdit_c_out", mc, h, h, per_step),
              ("mmdit_x_fc1", mx, h, f, per_step), ("mmdit_x_fc2", mx, f, h, per_step),
              ("mmdit_c_fc1", mc, h, f, per_step), ("mmdit_c_fc2", mc, f, h, per_step),
              ("mmdit_mod", batch, h, 6 * h, 2 * per_step),
              ("mmdit_proj_in", mx, m.token_dim, h, steps),
              ("mmdit_ctx_in", mc, m.joint_attention_dim, h, 1),
              ("mmdit_t_fc1", 1, m.frequency_embedding_size, h, steps),
              ("mmdit_t_fc2", 1, h, h, steps),
              ("mmdit_pool_fc1", batch, m.pooled_projection_dim, h, steps),
              ("mmdit_pool_fc2", batch, h, h, steps),
              ("mmdit_final_mod", batch, h, 2 * h, steps)]
    return [(name + SD3, *rest) for name, *rest in shapes]


def _library_gemm(xq, wq):
    """One library call computing xq @ wq (a yardstick only; the port's
    "pallas" route never calls it), on M zero-padded to what it accepts."""
    import torch

    from distrifuser_tpu_torch.ops.linear import pad_rows_for_library

    xp = pad_rows_for_library(xq)
    if xq.dtype == torch.int8:
        return lambda: torch._int_mm(xp, wq)
    one = torch.ones((), dtype=torch.float32, device=xq.device)
    return lambda: torch._scaled_mm(xp, wq, scale_a=one, scale_b=one,
                                    out_dtype=torch.float32)


def _library_fused_fp8(xq, wq, sx, sw):
    """One library call computing the fp8 fused form without bias,
    bf16((xq @ wq) * sx[:, None] * sw): torch._scaled_mm with row-wise
    scales (a yardstick only), on M zero-padded to a multiple of 16."""
    import torch

    from distrifuser_tpu_torch.ops.linear import pad_rows_for_library

    xp = pad_rows_for_library(xq)
    sxp = torch.ones((xp.shape[0], 1), dtype=torch.float32, device=xq.device)
    sxp[:xq.shape[0], 0] = sx
    swr = sw.reshape(1, -1).contiguous()
    return lambda: torch._scaled_mm(xp, wq, scale_a=sxp, scale_b=swr,
                                    out_dtype=torch.bfloat16)


def _bound(ops, nbytes):
    """(bound ms, what bounds it) of ``ops`` 8-bit operations and ``nbytes``
    bytes of device memory traffic on the card."""
    ops_ms, bytes_ms = ops / PEAK_8BIT_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def quant_kernel_phase(shapes):
    import torch

    from distrifuser_tpu_torch.ops import quant_matmul as qm
    from distrifuser_tpu_torch.ops import quantize as qz
    from distrifuser_tpu_torch.parallel.compress import quantize, quantize_weight

    odd = [(f"odd_{m}x{k}x{n}", m, k, n, 0) for m, k, n in ODD_QUANT_SHAPES]
    results = []
    for name, m, k, n, calls in list(shapes) + odd:
        for mode in ("int8", "fp8"):
            g = torch.Generator(device="cuda").manual_seed(len(results))
            x = torch.randn(m, k, device="cuda", generator=g).bfloat16()
            w = (torch.randn(k, n, device="cuda", generator=g) / k**0.5).bfloat16()
            bias = torch.randn(n, device="cuda", generator=g).bfloat16()
            qt = quantize_weight(w, mode)
            wq, sw = qt.payload, qt.channel_scale()
            row = {"shape": name, "mode": mode, "M": m, "K": k, "N": n,
                   "launches_per_call": calls}

            # per-token quantization: bit for bit with compress.quantize
            xq, sx = qz.quantize_rows(x, mode)
            want_q, want_s = quantize(x, mode)
            if not (torch.equal(xq.view(torch.uint8), want_q.view(torch.uint8))
                    and torch.equal(sx, want_s)):
                raise AssertionError(f"quantize_rows {mode} {name}: not bit-identical "
                                     "to compress.quantize")
            row["quantize_max_abs_err"] = 0.0

            # the fp32 contract form and the fused form against the plain version
            fused = {"sx": sx, "out_dtype": torch.bfloat16}
            checks = (("", {}, QUANT_FP8_REL), ("fused_", fused, QUANT_FP8_FUSED_REL))
            for prefix, kw, fp8_rel in checks:
                got = qm.quant_matmul(xq, wq, sw, **kw)
                want = qm.quant_matmul_reference(xq, wq, sw, **kw)
                ref_max = want.float().abs().max().item()
                err = (got.float() - want.float()).abs().max().item()
                row[prefix + "max_abs_err"], row[prefix + "max_abs_ref"] = err, ref_max
                if mode == "int8" and not torch.equal(got, want):
                    raise AssertionError(f"quant_matmul int8 {prefix}{name}: not "
                                         f"bit-identical to the plain version (max |d| {err})")
                if mode == "fp8" and err > fp8_rel * ref_max:
                    raise AssertionError(f"quant_matmul fp8 {prefix}{name}: max |d| {err} "
                                         f"over {fp8_rel} * {ref_max}")
            # the bias in the epilogue, as linear adds it: int8 bit for bit with
            # the plain version; fp8 bit for bit with the kernel's own fused
            # output plus the bias (the plain version rounds twice, so a one-ulp
            # difference before the bias can become two after it)
            got_b = qm.quant_matmul(xq, wq, sw, bias=bias, **fused)
            want_b = (qm.quant_matmul_reference(xq, wq, sw, bias=bias, **fused)
                      if mode == "int8" else got + bias)
            if not torch.equal(got_b, want_b):
                raise AssertionError(f"quant_matmul {mode} fused_bias_{name}: the bias "
                                     "epilogue is not linear's cast-then-add")
            torch.cuda.synchronize()

            fns = {
                "contract": lambda: qm.quant_matmul(xq, wq, sw),
                "fused": lambda: qm.quant_matmul(xq, wq, sw, sx=sx,
                                                 out_dtype=torch.bfloat16),
                "quantize": lambda: qz.quantize_rows(x, mode),
            }
            plains = {
                "contract": lambda: qm.quant_matmul_reference(xq, wq, sw),
                "fused": lambda: qm.quant_matmul_reference(xq, wq, sw, sx=sx,
                                                           out_dtype=torch.bfloat16),
                "quantize": lambda: quantize(x, mode),
            }
            libraries = {"contract": _library_gemm(xq, wq),
                         "fused": _library_fused_fp8(xq, wq, sx, sw) if mode == "fp8"
                         else None,
                         "quantize": None}
            prefixes = {"contract": "", "fused": "fused_", "quantize": "quantize_"}
            for key, prefix in prefixes.items():
                row[prefix + "ms"] = time_ms(fns[key], target_ms=QUANT_TARGET_MS)
                row[prefix + "plain_ms"] = time_ms(plains[key], target_ms=QUANT_TARGET_MS,
                                                   max_iters=5)
                row[prefix + "device_ms"] = device_ms(fns[key], iters=10) if calls else None
                lib = libraries[key]
                row[prefix + "library_ms"] = row[prefix + "library_device_ms"] = None
                if lib is not None:
                    try:
                        row[prefix + "library_ms"] = time_ms(lib, target_ms=QUANT_TARGET_MS)
                        if calls:
                            row[prefix + "library_device_ms"] = device_ms(lib, iters=10)
                    except RuntimeError as e:  # no library kernel for this shape
                        print(f"library {key} unavailable at {name}/{mode}: {e}",
                              file=sys.stderr)
            t_host = time.perf_counter()  # enqueue only: the card drains afterwards
            for _ in range(HOST_CALLS):
                fns["fused"]()
            row["host_us_per_launch"] = (time.perf_counter() - t_host) / HOST_CALLS * 1e6
            torch.cuda.synchronize()
            t_host = time.perf_counter()
            for _ in range(HOST_CALLS):
                fns["quantize"]()
            row["quantize_host_us_per_launch"] = (
                (time.perf_counter() - t_host) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()

            ops = 2.0 * m * k * n
            operands = m * k + k * n + 4.0 * n  # xq, wq, sw in
            bounds = {"": _bound(ops, operands + 4.0 * m * n),  # fp32 out
                      "fused_": _bound(ops, operands + 4.0 * m + 2.0 * m * n),  # sx; bf16 out
                      "quantize_": _bound(0.0, 2.0 * m * k + m * k + 4.0 * m)}
            for prefix, (ms, by) in bounds.items():
                row[prefix + "bound_ms"], row[prefix + "bound_by"] = ms, by
            row["fused_tops"] = ops / (row["fused_ms"] * 1e-3) / 1e12
            row.update(qm.variant(mode))
            print(json.dumps(row), flush=True)
            results.append(row)
            del x, w, bias, xq, sx, qt, wq, sw, want_q, want_s, got, want, got_b, want_b
            del fns, plains, libraries
            torch.cuda.empty_cache()
    return results


def cold_device_ms(fn, kernel, flush, iters=10):
    """Mean device time per call of the kernels whose name holds
    ``kernel``, each call made after ``flush`` (a buffer several times
    the L2) is read, so that the call reads its inputs from device memory
    and evicts only clean lines; None if the profiler recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key)
    return total_us / iters / 1e3 if total_us > 0 else None


def quant_device_phase(shapes, encoder_source=None):
    """Device time (torch.profiler) of ``quant_matmul(xq, wq, sw)``, the
    fp32 contract form, and of ``quantize_rows(x, mode)``, the per-token
    quantization of the bf16 activation (warm, and with a cold L2), at
    every path shape and mode, on operands made as quant_kernel_phase makes
    them; one line per shape, then the sums over one pipeline call's
    launches per model family and mode.  ``encoder_source``: time the
    quantization kernel built from that source instead, and report whether
    its payloads and scales equal the plain version's."""
    import torch

    from distrifuser_tpu_torch.ops import quant_matmul as qm
    from distrifuser_tpu_torch.ops import quantize as qz
    from distrifuser_tpu_torch.parallel.compress import quantize, quantize_weight

    if encoder_source is not None:
        from distrifuser_tpu_torch.ops._build import KernelLibrary

        variant = KernelLibrary(os.path.abspath(encoder_source),
                                qz._binder("quantize_rows", qz._QuantSpec))
        report = [line.strip() for line in variant.build().splitlines()
                  if "registers" in line or "spill" in line]
        print(json.dumps({"phase": "quant_device", "encoder_source": encoder_source,
                          "ptxas": report}), flush=True)
        qz._ENCODE._lib = variant.lib
    flush = torch.empty(2**26, dtype=torch.float32, device="cuda")  # 256 MB
    per_call = {}
    for i, (name, m, k, n, calls) in enumerate(shapes):
        for mode in ("int8", "fp8"):
            g = torch.Generator(device="cuda").manual_seed(2 * i + (mode == "fp8"))
            x = torch.randn(m, k, device="cuda", generator=g).bfloat16()
            w = (torch.randn(k, n, device="cuda", generator=g) / k**0.5).bfloat16()
            xq, _ = quantize(x, mode)
            qt = quantize_weight(w, mode)
            wq, sw = qt.payload, qt.channel_scale()
            times = {"device_ms": device_ms(lambda: qm.quant_matmul(xq, wq, sw), iters=10),
                     "quantize_device_ms": device_ms(lambda: qz.quantize_rows(x, mode),
                                                     iters=10),
                     "quantize_cold_device_ms": cold_device_ms(
                         lambda: qz.quantize_rows(x, mode), "quantize_rows", flush)}
            extra = {}
            if encoder_source is not None:
                got_q, got_s = qz.quantize_rows(x, mode)
                want_q, want_s = quantize(x, mode)
                extra["matches_plain"] = bool(
                    torch.equal(got_q.view(torch.uint8), want_q.view(torch.uint8))
                    and torch.equal(got_s, want_s))
            for key, ms in times.items():
                slot = (family(name), mode, key)
                prev = per_call.get(slot, 0.0)
                per_call[slot] = None if ms is None or prev is None else prev + ms * calls
            print(json.dumps({"phase": "quant_device", "shape": name, "mode": mode, "M": m,
                              "K": k, "N": n, "launches_per_call": calls, **times,
                              **extra}), flush=True)
    print(json.dumps({"phase": "quant_device", "device_ms_per_call": {
        f"{fam}/{mode}/{key}": ms for (fam, mode, key), ms in per_call.items()}}), flush=True)


def tiny_sd15_config():
    """SD 1.5's block structure (conv projections, no added conditioning)
    at narrow widths whose head dims are SD 1.5's 40 and 80."""
    from distrifuser_tpu_torch.models import unet

    return unet.UNetConfig(
        block_out_channels=(80, 80, 160, 160),
        down_block_types=("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",),
        up_block_types=("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3,
        layers_per_block=1, transformer_layers_per_block=(1, 1, 1, 1),
        num_attention_heads=(2, 2, 2, 2), cross_attention_dim=32, norm_num_groups=8,
        use_linear_projection=False, addition_embed_type=None,
        projection_class_embeddings_input_dim=0)


def tiny_check(weight_quant="none", steps=3, model="sdxl", scheduler="ddim", prompts=1,
               **fields):
    """Tiny pipeline of ``model`` ("sdxl": the SDXL block structure; "sd15":
    ``tiny_sd15_config``, its head dims 40 and 80): bf16 on the card
    (kernels) vs float32 on the CPU (plain versions), same weights and
    latents, ``prompts`` prompts (1 or 2); a quantized check quantizes the
    same dense weights on each side.  ``fields`` go to both configs (the
    patch phase passes the sync mode and warmup).  Returns the result line;
    raises over the limit."""
    import numpy as np
    import torch

    from distrifuser_tpu_torch import DistriConfig, DistriSDPipeline, DistriSDXLPipeline
    from distrifuser_tpu_torch.models import clip, unet, vae
    from distrifuser_tpu_torch.models.unet import cast_params

    gen = torch.Generator().manual_seed(0)
    vcfg = vae.tiny_vae_config()
    if model == "pixart":
        return _tiny_pixart_check(steps, scheduler, prompts, **fields)
    if model in ("sd3", "sd35m"):
        return _tiny_sd3_check(steps, prompts, weight_quant, sd35=model == "sd35m",
                               **fields)
    if model == "sd15":
        cls, ucfg, tcfgs = DistriSDPipeline, tiny_sd15_config(), [clip.tiny_clip_config()]
    else:
        cls, ucfg = DistriSDXLPipeline, unet.tiny_config(cross_attention_dim=32, sdxl=True)
        tcfgs = [clip.tiny_clip_config(hidden=16),
                 clip.CLIPTextConfig(vocab_size=1000, hidden_size=16, num_hidden_layers=2,
                                     num_attention_heads=4, intermediate_size=32,
                                     projection_dim=32)]
    trees = (unet.init_unet_params(gen, ucfg), vae.init_vae_params(gen, vcfg),
             [clip.init_clip_params(gen, tc) for tc in tcfgs])
    latents = np.random.RandomState(0).randn(prompts, 16, 16, 4).astype(np.float32)
    texts = ["a lighthouse at dusk", "a red boat on a lake"][:prompts]
    quant = {} if weight_quant == "none" else {"weight_quant": weight_quant,
                                                "quant_compute": "pallas"}
    outs = []
    for device, dtype in CHECK_DEVICES:
        dtype = getattr(torch, dtype)
        u, v = (cast_params(t, dtype, device) for t in trees[:2])
        ts = [cast_params(t, dtype, device) for t in trees[2]]
        cfg = DistriConfig(device=device, height=128, width=128, **quant, **fields)
        pipe = cls.from_params(cfg, ucfg, u, vcfg, v, tcfgs, ts, scheduler=scheduler)
        outs.append(np.stack(pipe(texts, num_inference_steps=steps, latents=latents,
                                  output_type="latent").images))
    ref, got = outs
    if not np.isfinite(got).all():
        raise AssertionError("tiny pipeline on the card gave non-finite latents")
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    limit = TINY_REL_L2["fp8" if "fp8" in (weight_quant, fields.get("comm_compress"))
                        else weight_quant]
    result = {"phase": "tiny_check", "model": model, "scheduler": scheduler,
              "weight_quant": weight_quant, "steps": steps, "prompts": prompts, **fields,
              "rel_l2": rel,
              "max_abs": float(np.abs(got - ref).max()), "limit_rel_l2": limit}
    if rel > limit:
        raise AssertionError(f"tiny pipeline ({weight_quant}, {fields}) bf16/card vs "
                             f"fp32/cpu rel L2 {rel} over {limit}")
    return result


def _tiny_pixart_check(steps, scheduler, prompts, heads=TINY_PIXART_HEADS, depth=2,
                       **fields):
    """``tiny_check`` of the tiny PixArt pipeline: a ``depth``-block DiT of
    ``heads`` heads of PixArt's d = 72, the tiny T5, the tiny VAE, bf16 on the card vs
    float32 on the CPU from the same weights and latents, relative L2 within
    TINY_REL_L2 (fp8's with fp8 refresh payloads)."""
    import numpy as np
    import torch

    from distrifuser_tpu_torch import DistriConfig, DistriPixArtPipeline
    from distrifuser_tpu_torch.models import dit, t5, vae
    from distrifuser_tpu_torch.models.unet import cast_params

    gen = torch.Generator().manual_seed(0)
    dcfg = dit.DiTConfig(sample_size=16, hidden_size=72 * heads, depth=depth,
                         num_heads=heads, mlp_ratio=2, caption_dim=32)
    tcfg, vcfg = t5.tiny_t5_config(), vae.tiny_vae_config()
    trees = (dit.init_dit_params(gen, dcfg), vae.init_vae_params(gen, vcfg),
             t5.init_t5_params(gen, tcfg))
    latents = np.random.RandomState(0).randn(prompts, 16, 16, 4).astype(np.float32)
    texts = ["a lighthouse at dusk", "a red boat on a lake"][:prompts]
    outs = []
    for device, dtype in CHECK_DEVICES:
        d, v, t = (cast_params(tree, getattr(torch, dtype), device) for tree in trees)
        cfg = DistriConfig(device=device, height=128, width=128, batch_size=prompts,
                           **fields)
        pipe = DistriPixArtPipeline.from_params(cfg, dcfg, d, vcfg, v, t5_config=tcfg,
                                                t5_params=t, scheduler=scheduler)
        outs.append(np.stack(pipe(texts, num_inference_steps=steps, latents=latents,
                                  output_type="latent").images))
    ref, got = outs
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    limit = TINY_REL_L2["fp8" if fields.get("comm_compress") == "fp8" else "none"]
    result = {"phase": "tiny_check", "model": "pixart", "scheduler": scheduler,
              "weight_quant": "none", "steps": steps, "prompts": prompts, **fields,
              "heads": heads, "head_dim": 72, "depth": depth, "rel_l2": rel,
              "max_abs": float(np.abs(got - ref).max()), "limit_rel_l2": limit}
    if not np.isfinite(got).all() or rel > limit:
        raise AssertionError(f"tiny PixArt pipeline ({fields}) bf16/card vs fp32/cpu: "
                             f"{result}")
    return result


def _tiny_sd3_check(steps, prompts, weight_quant="none", sd35=False, **fields):
    """``tiny_check`` of a tiny SD3 pipeline: a 2-block MMDiT of 2 heads of
    SD3's d = 64 (``sd35``: SD3.5-medium's shape, 3 blocks with q/k norms,
    the first 2 dual), the tiny CLIPs and T5 (7 T5 tokens: 84 context
    tokens beside 256 image tokens, neither a tile multiple), the tiny VAE
    with a latent shift; flow-euler, bf16 on the card vs float32 on the CPU
    from the same weights and latents, relative L2 within TINY_REL_L2.  On
    one card the launches are checked against the config: flash at every
    joint and dual attention, and under ``weight_quant`` both quant kernels
    at every MMDiT linear but final_out (10 a block, 3 a dual block, 6 a
    step, the context embedding once)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from distrifuser_tpu_torch import DistriConfig, DistriSD3Pipeline
    from distrifuser_tpu_torch.models import clip, mmdit, t5, vae
    from distrifuser_tpu_torch.models.unet import cast_params

    gen = torch.Generator().manual_seed(0)
    mcfg = mmdit.MMDiTConfig(sample_size=32, in_channels=4, out_channels=4,
                             hidden_size=64 * TINY_SD3_HEADS, depth=3 if sd35 else 2,
                             num_heads=TINY_SD3_HEADS, mlp_ratio=2, joint_attention_dim=32,
                             pooled_projection_dim=24, pos_embed_max_size=64, qk_norm=sd35,
                             dual_attention_blocks=2 if sd35 else 0)
    tcfgs = [clip.tiny_clip_config(hidden=16),
             clip.CLIPTextConfig(vocab_size=1000, hidden_size=16, num_hidden_layers=2,
                                 num_attention_heads=4, intermediate_size=32,
                                 projection_dim=8)]
    t5cfg = t5.tiny_t5_config()
    vcfg = dataclasses.replace(vae.tiny_vae_config(), shift_factor=0.1)
    trees = (mmdit.init_mmdit_params(gen, mcfg), vae.init_vae_params(gen, vcfg),
             [clip.init_clip_params(gen, tc) for tc in tcfgs], t5.init_t5_params(gen, t5cfg))
    latents = np.random.RandomState(0).randn(prompts, 32, 32, 4).astype(np.float32)
    texts = ["a lighthouse at dusk", "a red boat on a lake"][:prompts]
    quant = {} if weight_quant == "none" else {"weight_quant": weight_quant,
                                                "quant_compute": "pallas"}
    outs = []
    for device, dtype in CHECK_DEVICES:
        dtype = getattr(torch, dtype)
        m, v, t = (cast_params(tree, dtype, device)
                   for tree in (trees[0], trees[1], trees[3]))
        cs = [cast_params(tree, dtype, device) for tree in trees[2]]
        cfg = DistriConfig(device=device, height=256, width=256, batch_size=prompts,
                           **quant, **fields)
        pipe = DistriSD3Pipeline.from_params(cfg, mcfg, m, vcfg, v, tcfgs, cs,
                                             t5_config=t5cfg, t5_params=t,
                                             max_t5_tokens=TINY_SD3_T5_TOKENS)
        reset_counts()
        outs.append(np.stack(pipe(texts, num_inference_steps=steps, latents=latents,
                                  output_type="latent").images))
        launches = read_counts()
    ref, got = outs
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    limit = TINY_REL_L2["fp8" if "fp8" in (weight_quant, fields.get("comm_compress"))
                        else weight_quant]
    result = {"phase": "tiny_check", "model": "sd35m" if sd35 else "sd3",
              "scheduler": "flow-euler", "weight_quant": weight_quant, "steps": steps,
              "prompts": prompts, **fields, "head_dim": 64,
              "joint_tokens": 77 + TINY_SD3_T5_TOKENS + mcfg.num_tokens,
              "flash_sdpa_launches": launches["flash_sdpa"],
              "quant_matmul_launches": launches["quant_matmul"], "rel_l2": rel,
              "max_abs": float(np.abs(got - ref).max()), "limit_rel_l2": limit}
    if not dist.is_initialized():  # one card: the counts the config gives
        attn = steps * (mcfg.depth + mcfg.dual_attention_blocks)
        linears = 0 if weight_quant == "none" else (
            steps * (10 * mcfg.depth + 3 * mcfg.dual_attention_blocks + 6) + 1)
        want = {"flash_sdpa": attn, "quant_matmul": linears, "quantize_rows": linears}
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"tiny SD3 pipeline launches {launches}, expected {want}")
    if not np.isfinite(got).all() or rel > limit:
        raise AssertionError(f"tiny SD3 pipeline ({weight_quant}, {fields}) bf16/card vs "
                             f"fp32/cpu: {result}")
    return result


def stepcache_graph_check():
    """The step cache on one card at the tiny SDXL size: interval 2, depth 1,
    warmup 1, 6 DDIM steps (2 synchronous, then shallow, full, shallow,
    full), eagerly and under CUDA graphs, where a "shallow" graph resumes
    from the deep feature the full graph keeps and passes the buffers it
    skips through; the two latents must be equal bit for bit."""
    import numpy as np
    import torch

    from distrifuser_tpu_torch import DistriConfig, DistriSDXLPipeline
    from distrifuser_tpu_torch.models import clip, unet, vae
    from distrifuser_tpu_torch.models.unet import cast_params

    gen = torch.Generator().manual_seed(0)
    ucfg, vcfg = unet.tiny_config(cross_attention_dim=32, sdxl=True), vae.tiny_vae_config()
    tcfgs = [clip.tiny_clip_config(hidden=16),
             clip.CLIPTextConfig(vocab_size=1000, hidden_size=16, num_hidden_layers=2,
                                 num_attention_heads=4, intermediate_size=32,
                                 projection_dim=32)]
    trees = [cast_params(t, torch.bfloat16, "cuda")
             for t in (unet.init_unet_params(gen, ucfg), vae.init_vae_params(gen, vcfg))]
    texts = [cast_params(clip.init_clip_params(gen, tc), torch.bfloat16, "cuda")
             for tc in tcfgs]
    cfg = DistriConfig(height=128, width=128, warmup_steps=1, step_cache_interval=2,
                       step_cache_depth=1)
    pipe = DistriSDXLPipeline.from_params(cfg, ucfg, trees[0], vcfg, trees[1], tcfgs, texts)
    latents = np.random.RandomState(0).randn(1, 16, 16, 4).astype(np.float32)
    outs = {}
    for mode in ("eager", "graphed"):
        pipe.set_stepwise(mode == "eager")
        outs[mode] = pipe("a lighthouse at dusk", num_inference_steps=6, latents=latents,
                          output_type="latent").images[0]
    phases = dict(pipe.runner.phase_counts)
    line = {"phase": "stepcache_graph_check", "steps_by_phase": phases,
            "graphs": sorted(pipe.runner.graphs.graphs),
            "bit_identical": bool(np.array_equal(outs["eager"], outs["graphed"]))}
    if phases != {"sync": 4, "stale": 0, "shallow": 2} or not line["bit_identical"] \
            or not np.isfinite(outs["graphed"]).all():
        raise AssertionError(f"step cache on the card: {line}")
    return line


def model_configs(model):
    """(denoiser config, VAE config, text encoder configs) of a model family
    at its published widths: SDXL-base, SD 1.5, SD 2.1, PixArt-α (the
    DiT-XL/2 and T5-v1.1-XXL) or SD3-medium (the MMDiT, the SD3 VAE from its
    published config.json, CLIP-L, OpenCLIP-bigG and T5-v1.1-XXL)."""
    import dataclasses

    from distrifuser_tpu_torch.models import clip, dit, mmdit, t5, unet, vae

    if model == "pixart":
        return dit.pixart_config(), vae.sd_vae_config(), [t5.t5_v1_1_xxl_config()]
    if model == "sd3":  # CLIP-L with its 768 projection, bigG, T5-XXL
        return (mmdit.sd3_config(), vae.vae_config_from_json(SD3_VAE_JSON),
                [dataclasses.replace(clip.clip_vit_l_config(), projection_dim=768),
                 clip.open_clip_bigg_config(), t5.t5_v1_1_xxl_config()])
    if model == "sd15":
        return unet.sd15_config(), vae.sd_vae_config(), [clip.clip_vit_l_config()]
    if model == "sd21":
        return unet.sd21_config(), vae.sd_vae_config(), [clip.open_clip_vith_config()]
    return (unet.sdxl_config(), vae.sdxl_vae_config(),
            [clip.clip_vit_l_config(), clip.open_clip_bigg_config()])


def build_trees(model="sdxl", t5_layers=None):
    """Full-width configs of ``model`` and seeded random bf16 parameter
    trees on this rank's card: (denoiser config, denoiser tree, vae config,
    vae tree, text configs, text trees); PixArt's and SD3's T5 cut to
    ``t5_layers`` layers where given (full width)."""
    import dataclasses

    import torch

    from distrifuser_tpu_torch.models import clip, dit, mmdit, t5, unet, vae

    gen = torch.Generator(device="cuda").manual_seed(0)
    ucfg, vcfg, tcfgs = model_configs(model)
    dtype = torch.bfloat16
    if model == "pixart":
        tcfg = dataclasses.replace(tcfgs[0], num_layers=t5_layers or tcfgs[0].num_layers)
        return (ucfg, dit.init_dit_params(gen, ucfg, dtype), vcfg,
                vae.init_vae_params(gen, vcfg, dtype), [tcfg],
                [t5.init_t5_params(gen, tcfg, dtype)])
    if model == "sd3":
        tcfg = dataclasses.replace(tcfgs[2], num_layers=t5_layers or tcfgs[2].num_layers)
        return (ucfg, mmdit.init_mmdit_params(gen, ucfg, dtype), vcfg,
                vae.init_vae_params(gen, vcfg, dtype), [*tcfgs[:2], tcfg],
                [clip.init_clip_params(gen, tc, dtype) for tc in tcfgs[:2]]
                + [t5.init_t5_params(gen, tcfg, dtype)])
    return (ucfg, unet.init_unet_params(gen, ucfg, dtype), vcfg,
            vae.init_vae_params(gen, vcfg, dtype), tcfgs,
            [clip.init_clip_params(gen, tc, dtype) for tc in tcfgs])


def build_pipeline(trees, model="sdxl", scheduler="ddim", **quant):
    """The pipeline of ``model`` (DistriSDXLPipeline at 1024x1024,
    DistriSDPipeline at 512x512 for SD 1.5 and 768x768 for SD 2.1, with
    v-prediction, DistriPixArtPipeline at 1024x1024 with DPM-solver,
    DistriSD3Pipeline at 1024x1024 with flow-euler and 77 T5 tokens) on this
    rank's card (bf16) from ``trees``, with the
    ``quant`` config fields (weight quantization at load time, sync mode,
    warmup); returns (pipeline, seconds to build)."""
    import torch

    from distrifuser_tpu_torch import (DistriConfig, DistriPixArtPipeline, DistriSD3Pipeline,
                                       DistriSDPipeline, DistriSDXLPipeline)
    from distrifuser_tpu_torch.schedulers import get_scheduler

    t_init = time.perf_counter()
    ucfg, unet_p, vcfg, vae_p, tcfgs, text_p = trees
    size = SIZES[model]
    cfg = DistriConfig(height=size, width=size, **quant)  # this rank's card, bf16
    if model == "pixart":  # DPM-solver, the PixArt pipeline's default
        pipe = DistriPixArtPipeline.from_params(cfg, ucfg, unet_p, vcfg, vae_p,
                                                t5_config=tcfgs[0], t5_params=text_p[0],
                                                scheduler="dpm-solver")
        torch.cuda.synchronize()
        return pipe, time.perf_counter() - t_init
    if model == "sd3":
        pipe = DistriSD3Pipeline.from_params(cfg, ucfg, unet_p, vcfg, vae_p, tcfgs[:2],
                                             text_p[:2], t5_config=tcfgs[2],
                                             t5_params=text_p[2], scheduler="flow-euler",
                                             max_t5_tokens=SD3_T5_TOKENS)
        torch.cuda.synchronize()
        return pipe, time.perf_counter() - t_init
    cls = DistriSDXLPipeline if model == "sdxl" else DistriSDPipeline
    if model == "sd21":
        scheduler = get_scheduler(scheduler, prediction_type="v_prediction")
    pipe = cls.from_params(cfg, ucfg, unet_p, vcfg, vae_p, tcfgs, text_p,
                           scheduler=scheduler)
    torch.cuda.synchronize()
    return pipe, time.perf_counter() - t_init


MODEL_NAMES = {"sdxl": "SDXL-base widths", "sd15": "SD 1.5 widths",
               "sd21": "SD 2.1 widths (v-prediction)",
               "pixart": "PixArt-α widths (DiT-XL/2, T5-v1.1-XXL, SD VAE)",
               "sd3": "SD3-medium widths (MMDiT, CLIP-L, OpenCLIP-bigG, T5-v1.1-XXL, "
                      "SD3 VAE)"}


def reset_counts():
    """Every kernel wrapper's launch count set to 0, and the all-to-alls'."""
    from distrifuser_tpu_torch.ops import flash_attention as fa
    from distrifuser_tpu_torch.ops import quant_matmul as qm
    from distrifuser_tpu_torch.ops import quantize as qz
    from distrifuser_tpu_torch.parallel.collectives import all_to_all

    fa.flash_sdpa.launches = fa.flash_sdpa.lse_launches = 0
    fa.flash_sdpa.launches_by_head_dim.clear()
    fa.flash_sdpa.lse_launches_by_head_dim.clear()
    qm.quant_matmul.launches = 0
    for fn in (qz.quantize_rows, qz.quantize_rows_grouped, qz.dequantize_rows_grouped,
               all_to_all):
        fn.launches = 0


def read_counts():
    from distrifuser_tpu_torch.ops import flash_attention as fa
    from distrifuser_tpu_torch.ops import quant_matmul as qm
    from distrifuser_tpu_torch.ops import quantize as qz
    from distrifuser_tpu_torch.parallel.collectives import all_to_all

    return {"flash_sdpa": fa.flash_sdpa.launches,
            "flash_sdpa_lse": fa.flash_sdpa.lse_launches,
            "quant_matmul": qm.quant_matmul.launches,
            "quantize_rows": qz.quantize_rows.launches + qz.quantize_rows_grouped.launches,
            "dequantize_rows": qz.dequantize_rows_grouped.launches,
            "all_to_all": all_to_all.launches}


def counted_call(fn, label, flash_expected):
    """``fn()`` with every launch count set to 0 just before it and read
    just after it, the card synchronised around it: (result, seconds,
    launches); raises unless the flash kernel launched ``flash_expected``
    times."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    if launches["flash_sdpa"] != flash_expected:
        raise AssertionError(f"{label}: {launches['flash_sdpa']} flash launches, "
                             f"expected {flash_expected}")
    return out, seconds, launches


def init_image(size, seed=0):
    """A seeded uint8 RGB image [size, size, 3] (img2img's input)."""
    import numpy as np

    return np.random.RandomState(seed).randint(0, 256, (size, size, 3), dtype=np.uint8)


def image_digest(img):
    return hashlib.sha256(img.tobytes()).hexdigest()


def pipeline_run(pipe, init_s, label, expected, model="sdxl", num_steps=4, prompts=None):
    """One ``num_steps``-step call at the pipeline's size of ``prompts``
    (default: PROMPT alone) with every launch count set to 0 just before it
    and read just after it; checks the images and the counts against
    ``expected`` (its keys; the log-sum-exp launches must be 0 unless it
    names them) and returns (result line, final latents).  An eager call
    also reports the flash launches by head dim; every call those of the
    d = 512 instances (the VAE's, never graphed): its plain and its
    log-sum-exp one."""
    import numpy as np
    import torch

    from distrifuser_tpu_torch.ops import flash_attention as fa

    marks, last = [], {}

    def on_step(i, t, x):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        last["x"] = x

    prompts = prompts or [PROMPT]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = pipe(prompts, num_inference_steps=num_steps, seed=0, output_type="np",
               callback=on_step)
    total_s = time.perf_counter() - t0
    launches = read_counts()
    by_head_dim = dict(sorted(fa.flash_sdpa.launches_by_head_dim.items()))
    lse512 = fa.flash_sdpa.lse_launches_by_head_dim[512]
    d512 = {"plain": fa.flash_sdpa.launches_by_head_dim[512] - lse512, "lse": lse512}
    cfg = pipe.distri_config
    for img in out.images:
        if img.shape != (cfg.height, cfg.width, 3) or not np.isfinite(img).all():
            raise AssertionError(f"{label}: image shape {img.shape}, finite "
                                 f"{np.isfinite(img).all()}")
    if len(out.images) != len(prompts):
        raise AssertionError(f"{label}: {len(out.images)} images for {len(prompts)} prompts")
    img = np.concatenate(out.images)
    if launches != {"flash_sdpa_lse": 0, "dequantize_rows": 0, "all_to_all": 0, **expected}:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expected}")
    pixels = (img * 255).round().astype(np.uint8)
    steps = [(marks[i] - marks[i - 1]) * 1e3 for i in range(1, len(marks))]
    report = pipe.weight_report()
    result = {
        "phase": "pipeline", "run": label,
        "model": MODEL_NAMES[model] + ", random bf16 weights",
        "scheduler": type(pipe.scheduler).__name__,
        "weight_quant": report["weight_quant"],
        "weight_quant_aux": report["weight_quant_aux"],
        "quant_compute": report["quant_compute"],
        "height": cfg.height, "width": cfg.width, "steps": num_steps,
        "prompts": len(prompts),
        "init_s": init_s, "total_s": total_s,
        "first_step_ms_incl_text_encode": (marks[0] - t0) * 1e3,
        "step_ms": steps, "decode_and_copy_ms": (t0 + total_s - marks[-1]) * 1e3,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "max_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
        "use_cuda_graph": pipe.distri_config.use_cuda_graph,
        "weight_bytes": report["per_component_nbytes"],
        "flash_sdpa_launches": launches["flash_sdpa"],
        "flash_sdpa_lse_launches": launches["flash_sdpa_lse"],
        **({} if cfg.use_cuda_graph else {"flash_sdpa_launches_by_head_dim": by_head_dim}),
        "flash_sdpa_d512_launches": d512,
        "quant_matmul_launches": launches["quant_matmul"],
        "quantize_rows_launches": launches["quantize_rows"],
        "dequantize_rows_launches": launches["dequantize_rows"],
        "all_to_all_calls": launches["all_to_all"],
        "pixel_mean": float(pixels.mean()),
        "image_sha256": image_digest(img),
        **({} if len(prompts) == 1 else
           {"image_sha256_each": [image_digest(im) for im in out.images]}),
    }
    return result, last["x"].float().cpu().numpy()


def graphed_runs(pipe, init_s, label, expected, steps=4, model="sdxl", prompts=None):
    """The pipeline's warm call eagerly, then under CUDA graphs (captured
    by ``prepare``, then one untimed call), each measured by
    ``pipeline_run``; returns (eager line, graphed line, the graphed vs
    eager comparison, the graphed latent).  The two must give the same
    latent and image bit for bit (one card), or within GRAPH_REL_L2
    relative L2 (ranks over NCCL, whose sums may be ordered differently
    under capture; the line says which held)."""
    import numpy as np

    prompts = prompts or [PROMPT]
    pipe.set_stepwise(True)
    t0 = time.perf_counter()  # a first call loads kernels and picks algorithms
    pipe(prompts, num_inference_steps=steps, seed=0, output_type="np")
    eager_warmup_s = time.perf_counter() - t0
    eager, eager_x = pipeline_run(pipe, init_s, label, expected, model, steps, prompts)
    eager["warmup_call_s"] = eager_warmup_s
    pipe.set_stepwise(False)
    t0 = time.perf_counter()
    pipe.prepare(steps)
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe(prompts, num_inference_steps=steps, seed=0, output_type="np")
    first_s = time.perf_counter() - t0
    graphed, graphed_x = pipeline_run(pipe, init_s, label + " graphed", expected, model,
                                      steps, prompts)
    graphed.update({"prepare_capture_s": capture_s, "first_graphed_call_s": first_s,
                    "graphs": sorted(pipe.runner.graphs.graphs)})
    rel = float(np.linalg.norm(graphed_x - eager_x) / np.linalg.norm(eager_x))
    same = bool(np.array_equal(graphed_x, eager_x))
    compare = {"phase": "graph_vs_eager", "run": label,
               "latent_bit_identical": same,
               "image_bit_identical": graphed["image_sha256"] == eager["image_sha256"],
               "latent_rel_l2": rel, "eager_call_s": eager["total_s"],
               "graphed_call_s": graphed["total_s"], "capture_s": capture_s,
               "eager_peak_reserved_bytes": eager["max_memory_reserved_bytes"],
               "graphed_peak_reserved_bytes": graphed["max_memory_reserved_bytes"],
               "eager_peak_allocated_bytes": eager["max_memory_allocated_bytes"],
               "graphed_peak_allocated_bytes": graphed["max_memory_allocated_bytes"]}
    return eager, graphed, compare, graphed_x


def pipeline_phase(trees, expected_flash, expected_quant):
    """The main path three times from one set of dense trees: dense, int8
    (UNet and aux models) and fp8 (UNet), the quantized runs through the
    quantized-matmul kernel; each eagerly and under CUDA graphs, which must
    agree bit for bit; on the dense pipeline also img2img, the handoff and
    the refiner (``img2img_handoff_phase``), on each quantized one the save
    and load of its UNet tree (``save_load_check``).  Returns the result
    lines by run and the dense call's final latent."""
    import numpy as np
    import torch

    runs = (("dense", {}, 0),
            ("int8", {"weight_quant": "int8", "weight_quant_aux": "int8",
                      "quant_compute": "pallas"}, expected_quant),
            ("fp8", {"weight_quant": "fp8", "quant_compute": "pallas"}, expected_quant))
    results, dense_latent = {}, None
    for label, quant, n_quant in runs:
        pipe, init_s = build_pipeline(trees, **quant)
        eager, graphed, compare, latent = graphed_runs(
            pipe, init_s, label, {"flash_sdpa": expected_flash, "quant_matmul": n_quant,
                                  "quantize_rows": n_quant})
        if dense_latent is None:
            dense_latent = latent
        else:  # information only: quantization moves the image
            graphed["latent_rel_l2_vs_dense"] = float(
                np.linalg.norm(latent - dense_latent) / np.linalg.norm(dense_latent))
        for line in (eager, graphed, compare):
            print(json.dumps(line), flush=True)
        if not (compare["latent_bit_identical"] and compare["image_bit_identical"]):
            raise AssertionError(f"{label}: the graphed call differs from the eager "
                                 f"one (latent rel L2 {compare['latent_rel_l2']})")
        results[label] = graphed
        if label == "dense":
            results.update(img2img_handoff_phase(pipe, trees))
        else:
            results["save_load_" + label] = save_load_check(
                pipe, trees, label, quant, {"flash_sdpa": expected_flash,
                                            "quant_matmul": n_quant,
                                            "quantize_rows": n_quant}, graphed, latent)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    return results, dense_latent


def save_load_check(pipe, trees, label, quant, expected, graphed, latent):
    """ROADMAP item 12 on the card: the quantized UNet tree of ``pipe`` (the
    main path's ``label`` run) saved with ``models.weights.save_params`` to
    build/save_load/, loaded back with ``load_params``, moved to the card
    (``models.unet.cast_params``) and given to a fresh pipeline of the same
    fields (``from_params``); its graphed call (``prepare``, then the
    measured one) must give the main path's graphed latent and image bit
    for bit, through the quantized-matmul kernel (``expected`` launches).
    Prints and returns a "save_load" line: the archive's bytes, the save,
    load, move and build seconds, the capture and the call."""
    import numpy as np
    import torch

    from distrifuser_tpu_torch.models.unet import cast_params
    from distrifuser_tpu_torch.models.weights import load_params, save_params

    folder = os.path.join("build", "save_load")
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, f"sdxl_unet_{label}.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_params(path, pipe.runner.params)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree = load_params(path)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree = cast_params(tree, torch.bfloat16, torch.device("cuda"))
    torch.cuda.synchronize()
    to_card_s = time.perf_counter() - t0
    ucfg, _, vcfg, vae_p, tcfgs, text_p = trees
    fresh, init_s = build_pipeline((ucfg, tree, vcfg, vae_p, tcfgs, text_p), **quant)
    t0 = time.perf_counter()
    fresh.prepare(4)
    capture_s = time.perf_counter() - t0
    line, got = pipeline_run(fresh, init_s, f"{label} reloaded", expected)
    out = {"phase": "save_load", "mode": label, "archive": path,
           "archive_bytes": os.path.getsize(path), "save_s": save_s, "load_s": load_s,
           "to_card_s": to_card_s, "build_s": init_s, "capture_s": capture_s,
           "call_s": line["total_s"], "launches": {k: line[k + "_launches"]
                                                   for k in expected},
           "latent_bit_identical": bool(np.array_equal(got, latent)),
           "image_bit_identical": line["image_sha256"] == graphed["image_sha256"]}
    print(json.dumps(out), flush=True)
    os.remove(path)
    if not (out["latent_bit_identical"] and out["image_bit_identical"]):
        raise AssertionError(f"save_load {label}: the reloaded pipeline's call differs "
                             "from the saved one's")
    del fresh, tree
    return out


def flops_phase(trees):
    """ROADMAP item 10 on the card: ``comm_volume_report(per_phase=True)``'s
    "flops" of the SDXL 1024x1024 pipeline under the step cache (interval
    2, depth 1; one eager 4-step call first, which the report reads), and
    the ``cli/profile_macs.py`` line of the SDXL preset at 1024x1024.  Both
    count on fake tensors (nothing runs on the card).  Prints and returns a
    "flops" line."""
    import torch

    from distrifuser_tpu_torch.cli.profile_macs import unet_flops

    pipe, _ = build_pipeline(trees, step_cache_interval=2, step_cache_depth=1,
                             warmup_steps=1, use_cuda_graph=False)
    pipe(PROMPT, num_inference_steps=4, seed=0, output_type="latent")
    t0 = time.perf_counter()
    report = pipe.runner.comm_volume_report(per_phase=True)
    count_s = time.perf_counter() - t0
    del pipe
    t0 = time.perf_counter()
    flops, nbytes, n_params = unet_flops("sdxl", SIZES["sdxl"], 1, torch.bfloat16)
    cli_s = time.perf_counter() - t0
    size = SIZES["sdxl"]
    out = {"phase": "flops", "config": "SDXL 1024x1024, CFG, step cache interval 2 depth 1",
           "flops": report["flops"], "count_s": count_s,
           "profile_macs": f"sdxl @ {size}x{size}: {flops / 1e9:.2f} GFLOPs "
                           f"(~{flops / 2e9:.2f} GMACs), {nbytes / 1e9:.2f} GB of weights, "
                           f"{n_params / 1e6:.1f}M params",
           "profile_macs_flops": flops, "profile_macs_s": cli_s}
    print(json.dumps(out), flush=True)
    return out


def pixart_phase():
    """PixArt-α at 1024x1024 on one card: the DiT of ``pixart_config()`` (28
    blocks of 1152, 16 heads of d = 72) and T5-v1.1-XXL whole (24 layers of
    4096, about 4.8 B parameters) with the SD VAE, seeded random bf16
    weights; one prompt, 4 DPM-solver steps to an image, eagerly and then
    under CUDA graphs (``graphed_runs``), which must agree bit for bit; the
    flash kernel 4 x 28 + 1 times a call (the eager call's launches by head
    dim: d = 72 112 times, the whole decode's d = 512 once).  Then the same
    trees under PipeFusion at one card (``parallelism="pipefusion"``, one
    stage of 28 blocks, 4 chunks of 1024 tokens, warmup 1): graphed, the
    flash kernel 2 x 28 + 8 x 28 + 1 times (2 mega-patch passes, 8 chunk
    passes, the decode), then its ticks replayed uncaptured, bit for bit
    (``pipefusion_runs``); its image against the dense call's (relative L2
    of the latents, information only).  Prints the lines and returns (eager
    line, graphed line, PipeFusion's graphed line)."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    trees = build_trees("pixart")
    trees_s = time.perf_counter() - t0
    pipe, init_s = build_pipeline(trees, "pixart")
    per_call = PIXART_STEPS * trees[0].depth
    eager, graphed, compare, dense_x = graphed_runs(
        pipe, init_s + trees_s, "pixart",
        {"flash_sdpa": per_call + 1, "quant_matmul": 0, "quantize_rows": 0},
        steps=PIXART_STEPS, model="pixart")
    params = {"dit": _param_count(trees[1]), "t5": _param_count(trees[5][0]),
              "vae": _param_count(trees[3])}
    for line in (eager, graphed):
        line.update({"parameters": params, "t5_layers": trees[4][0].num_layers,
                     "dit_depth": trees[0].depth, "head_dim": trees[0].head_dim})
        print(json.dumps(line), flush=True)
    print(json.dumps(compare), flush=True)
    if eager["flash_sdpa_launches_by_head_dim"] != {72: per_call, 512: 1}:
        raise AssertionError(f"pixart: flash launches by head dim "
                             f"{eager['flash_sdpa_launches_by_head_dim']}")
    if not (compare["latent_bit_identical"] and compare["image_bit_identical"]):
        raise AssertionError(f"pixart: the graphed call differs from the eager one "
                             f"(latent rel L2 {compare['latent_rel_l2']})")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    fields = {"parallelism": "pipefusion", "pipe_patches": PIPEFUSION_PATCHES,
              "warmup_steps": PATCH_WARMUP}
    pipe, pf_init_s = build_pipeline(trees, "pixart", **fields)
    pf, pf_eager, pf_compare = pipefusion_runs(pipe, "pixart pipefusion", fields)
    out = pipe(PROMPT, num_inference_steps=PIXART_STEPS, seed=0, output_type="latent")
    pf_x = np.asarray(out.images[0], np.float32)
    for line in (pf, pf_eager):
        line.update({"init_s": pf_init_s, "parameters": params, **pipefusion_line(
            pipe, PIXART_STEPS)})
        print(json.dumps(line), flush=True)
    pf_compare["pipefusion_vs_dense_latent_rel_l2"] = float(
        np.linalg.norm(pf_x - dense_x.reshape(pf_x.shape))
        / np.linalg.norm(dense_x))
    print(json.dumps(pf_compare), flush=True)
    if not pf_compare["latent_bit_identical"]:
        raise AssertionError(f"pixart pipefusion: the graphed ticks differ from the "
                             f"uncaptured ones (latent rel L2 {pf_compare['latent_rel_l2']})")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    pipe, _ = build_pipeline(trees, "pixart", batch_size=2, use_cuda_graph=False)
    step = step_drive(pipe, "pixart", PIXART_STEPS, PIXART_DEPTH)
    del pipe, trees
    gc.collect()
    torch.cuda.empty_cache()
    return eager, graphed, pf, step


def pipefusion_counts(fields, steps, stages, stage, depth=PIXART_DEPTH):
    """(tick passes, kernel launches) of one PipeFusion call on the rank at
    ``stage`` of ``stages`` with config ``fields`` (parallel/pipefusion.py:
    one mega-patch pass a synchronous step, one chunk pass an item, a deep
    stage's shallow items passed through; every item hops once into every
    stage): the flash kernel depth / stages times a full pass and once for
    the whole decode; under ``comm_compress`` the encoder once an item sent
    and the decoder once an item received, the residual code's
    reconstruction one decode more."""
    patches = fields.get("pipe_patches") or stages
    n_sync = min(fields.get("warmup_steps", 4) + 1, steps)
    items = (steps - n_sync) * patches
    interval = fields.get("step_cache_interval", 1)
    shallow = 0
    if interval > 1 and stage >= stages - fields.get("step_cache_depth", 0):
        shallow = patches * sum((s - n_sync) % interval < interval - 1
                                for s in range(n_sync, steps))
    mode = fields.get("comm_compress", "none")
    codec = 0 if mode == "none" else items
    ticks = {"warmup": n_sync, "steady": items - shallow, "pass": shallow}
    return ticks, {"flash_sdpa": depth // stages * (n_sync + items - shallow) + 1,
                   "flash_sdpa_lse": 0, "quant_matmul": 0, "quantize_rows": codec,
                   "dequantize_rows": codec * (2 if mode == "int8_residual" else 1),
                   "all_to_all": 0}


def pipefusion_call(pipe, label, expected, steps=PIXART_STEPS):
    """One PipeFusion call of ``pipe`` (no step callback: a step is smeared
    over the pipeline's ticks) with every launch count set to 0 just before
    it and read just after: a finite image of the config's size and the
    launches ``expected``; its seconds, peak memory and weight bytes, each
    tick body's device ms (CUDA events around every replay, no host
    synchronisation) by kind, and the rank's device ms a step after the
    warmup (its chunk ticks).  Returns (line, final latent)."""
    import numpy as np
    import torch

    from distrifuser_tpu_torch.ops import flash_attention as fa

    runner = pipe.runner
    events, kept = {}, {}
    run_tick, generate = runner._run_tick, runner.generate

    def timed_tick(kind, h, step, m):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = run_tick(kind, h, step, m)
        end.record()
        events.setdefault(kind, []).append((start, end))
        return out

    def keep(*args, **kwargs):
        kept["latent"] = generate(*args, **kwargs)
        return kept["latent"]

    runner._run_tick, runner.generate = timed_tick, keep
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = pipe([PROMPT], num_inference_steps=steps, seed=0, output_type="np")
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = read_counts()
        lse512 = fa.flash_sdpa.lse_launches_by_head_dim[512]
        d512 = {"plain": fa.flash_sdpa.launches_by_head_dim[512] - lse512, "lse": lse512}
    finally:
        del runner._run_tick, runner.generate
    cfg = pipe.distri_config
    img = out.images[0]
    if img.shape != (cfg.height, cfg.width, 3) or not np.isfinite(img).all():
        raise AssertionError(f"{label}: image shape {img.shape}, finite "
                             f"{np.isfinite(img).all()}")
    if launches != expected:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expected}")
    tick_ms = {kind: sorted(a.elapsed_time(b) for a, b in pairs)
               for kind, pairs in events.items()}
    chunk_ms = tick_ms.get("steady", []) + tick_ms.get("pass", [])
    steady_steps = len(chunk_ms) // runner.patches
    report = pipe.weight_report()
    pixels = (img * 255).round().astype(np.uint8)
    line = {
        "phase": "pipeline", "run": label,
        "model": MODEL_NAMES["pixart"] + ", random bf16 weights",
        "scheduler": type(pipe.scheduler).__name__, "height": cfg.height,
        "width": cfg.width, "steps": steps, "prompts": 1, "total_s": total_s,
        "use_cuda_graph": cfg.use_cuda_graph,
        "ticks_captured": runner.capture_ticks, "tick_passes": dict(runner.tick_counts),
        "tick_device_ms": {kind: {"n": len(ms), "min": ms[0], "median": ms[len(ms) // 2],
                                  "max": ms[-1], "sum": sum(ms)}
                           for kind, ms in tick_ms.items()},
        # this rank's device time in one step after the warmup: its M chunk ticks
        "steady_step_device_ms": sum(chunk_ms) / steady_steps if steady_steps else None,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "max_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
        "weight_bytes": report["per_component_nbytes"],
        "flash_sdpa_launches": launches["flash_sdpa"],
        "flash_sdpa_lse_launches": launches["flash_sdpa_lse"],
        "flash_sdpa_d512_launches": d512,
        "quantize_rows_launches": launches["quantize_rows"],
        "dequantize_rows_launches": launches["dequantize_rows"],
        "pixel_mean": float(pixels.mean()), "image_sha256": image_digest(img),
    }
    return line, kept["latent"].float().cpu().numpy()


def pipefusion_runs(pipe, label, fields, steps=PIXART_STEPS):
    """A PipeFusion pipeline's calls: ``prepare`` (the tick bodies' capture,
    timed), one untimed call, the measured graphed call, then one with the
    same tick bodies replayed uncaptured (``capture_ticks = False``); each
    with the launches ``pipefusion_counts`` derives for this rank, its tick
    passes likewise.  Returns (graphed line, uncaptured line, comparison:
    bit for bit, or within GRAPH_REL_L2 relative L2 of the latent)."""
    import numpy as np

    runner = pipe.runner
    ticks, expected = pipefusion_counts(fields, steps, runner.stages, runner.stage)
    t0 = time.perf_counter()
    pipe.prepare(steps)
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe(PROMPT, num_inference_steps=steps, seed=0, output_type="np")
    first_s = time.perf_counter() - t0
    graphed, x = pipefusion_call(pipe, label, expected, steps)
    runner.capture_ticks = False
    try:
        eager, eager_x = pipefusion_call(pipe, label + " uncaptured", expected, steps)
    finally:
        runner.capture_ticks = True
    for line in (graphed, eager):
        if line["tick_passes"] != ticks:
            raise AssertionError(f"{label}: tick passes {line['tick_passes']}, expected "
                                 f"{ticks}")
    graphed.update({"prepare_capture_s": capture_s, "first_graphed_call_s": first_s,
                    "graphs": sorted(runner.graphs.graphs)})
    rel = float(np.linalg.norm(x - eager_x) / np.linalg.norm(eager_x))
    compare = {"phase": "graph_vs_eager", "run": label,
               "latent_bit_identical": bool(np.array_equal(x, eager_x)),
               "image_bit_identical": graphed["image_sha256"] == eager["image_sha256"],
               "latent_rel_l2": rel, "eager_call_s": eager["total_s"],
               "graphed_call_s": graphed["total_s"], "capture_s": capture_s,
               "eager_peak_allocated_bytes": eager["max_memory_allocated_bytes"],
               "graphed_peak_allocated_bytes": graphed["max_memory_allocated_bytes"]}
    if not (compare["latent_bit_identical"] or rel <= GRAPH_REL_L2):
        raise AssertionError(f"{label}: graphed latent rel L2 {rel} over {GRAPH_REL_L2}")
    return graphed, eager, compare


def pipefusion_line(pipe, steps):
    """What a PipeFusion call adds to its line: the runner's stage and
    ``comm_report`` (the hop bytes of a steady and of a synchronous step,
    the parameters this rank holds), ``comm_plan``, and the weights it
    holds (its stage's blocks and the shared parameters)."""
    runner = pipe.runner
    rep = runner.comm_report(1)
    return {"stage": runner.stage, "stages": runner.stages, "patches": runner.patches,
            "blocks_held": len(runner.params["blocks"]), "comm_report": rep,
            "comm_plan": pipe.comm_plan(steps),
            "hop_bytes_per_step": {"sync": rep["sync_step_collective_bytes"],
                                   "steady": rep["per_step_collective_bytes"]},
            "denoiser_parameters": _param_count(runner.params)}


def _pipefusion_rank(label, rank, world, graphs):
    """One rank of a PipeFusion run (PIPEFUSION_RUNS).  Ranks that share the
    card (gloo staging) must be refused: with ``use_cuda_graph=True`` for
    the staging, with False by PipeFusion itself; nothing runs.  Over NCCL:
    the tiny checks at this world (graphed on the card and on the CPU),
    then the full-width pipeline (T5 cut to SPAWN_T5_LAYERS; the DiT's other
    stages' blocks freed before the calls) through ``pipefusion_runs``."""
    import torch

    from distrifuser_tpu_torch import DistriConfig
    from distrifuser_tpu_torch.parallel.pipefusion import PipeFusionRunner
    from distrifuser_tpu_torch.schedulers import get_scheduler

    fields, tinies, _, model, steps = MULTI_RUNS[label]
    if not graphs:
        refused = {}
        for graph in (True, False):
            cfg = DistriConfig(height=SIZES[model], width=SIZES[model],
                               use_cuda_graph=graph, **fields)
            try:
                PipeFusionRunner(cfg, model_configs(model)[0], None,
                                 get_scheduler("dpm-solver"))
            except ValueError as e:
                refused[str(graph)] = str(e)
        if ("share a card" not in refused.get("True", "")
                or "use_cuda_graph=False" not in refused.get("False", "")):
            raise AssertionError(f"{label} rank {rank}: PipeFusion on ranks sharing the "
                                 f"card was not refused as expected: {refused}")
        return {"lines": [], "tiny": [], "compare": None,
                "refused": {"phase": f"{label}_shared_card_refused", "rank": rank,
                            "world": world, **refused}}
    tiny = [tiny_check(steps=steps, **{"model": model, **fields, **t}) for t in tinies]
    t0 = time.perf_counter()
    trees = build_trees(model, t5_layers=SPAWN_T5_LAYERS)
    trees_s = time.perf_counter() - t0
    pipe, init_s = build_pipeline(trees, model, **fields)
    del trees  # the other stages' blocks go
    gc.collect()
    torch.cuda.empty_cache()
    name = f"{label} rank {rank}"
    graphed, eager, compare = pipefusion_runs(pipe, name, fields, steps)
    free, total = torch.cuda.mem_get_info()
    for line in (graphed, eager):
        line.update({"phase": f"{label}_pipeline", "rank": rank, "world": world,
                     "init_s": init_s + trees_s,
                     "parallelism": "pipefusion", "batch_idx": pipe.distri_config.batch_idx(),
                     "split_idx": pipe.distri_config.split_idx(),
                     "t5_layers": SPAWN_T5_LAYERS, "card_used_bytes": total - free,
                     **pipefusion_line(pipe, steps)})
    del pipe
    torch.cuda.empty_cache()
    return {"lines": [graphed, eager], "tiny": tiny, "compare": compare}


def _param_count(tree):
    from distrifuser_tpu_torch.parallel import graphs

    return sum(t.numel() for t in graphs._leaves(tree))


def sd3_phase():
    """SD3-medium at 1024x1024 on one card: the MMDiT of ``sd3_config()``
    (24 joint blocks of 1536, 24 heads of d = 64, about 2.0 B parameters),
    CLIP-L, OpenCLIP-bigG and T5-v1.1-XXL whole, the SD3 VAE, seeded random
    bf16 weights; one prompt, 4 flow-euler steps to an image, eagerly and
    then under CUDA graphs (``graphed_runs``), which must agree bit for bit;
    the flash kernel 4 x 24 + 1 times a call (the eager call's launches by
    head dim: d = 64 96 times, the whole decode's d = 512 once).  Prints the
    lines and returns (eager line, graphed line)."""
    import torch

    t0 = time.perf_counter()
    trees = build_trees("sd3")
    trees_s = time.perf_counter() - t0
    pipe, init_s = build_pipeline(trees, "sd3")
    per_call = SD3_STEPS * trees[0].depth
    eager, graphed, compare, _ = graphed_runs(
        pipe, init_s + trees_s, "sd3",
        {"flash_sdpa": per_call + 1, "quant_matmul": 0, "quantize_rows": 0},
        steps=SD3_STEPS, model="sd3")
    params = {"mmdit": _param_count(trees[1]), "clip_l": _param_count(trees[5][0]),
              "clip_bigg": _param_count(trees[5][1]), "t5": _param_count(trees[5][2]),
              "vae": _param_count(trees[3])}
    for line in (eager, graphed):
        line.update({"parameters": params, "t5_layers": trees[4][2].num_layers,
                     "mmdit_depth": trees[0].depth, "head_dim": trees[0].head_dim,
                     "joint_tokens": SD3_CONTEXT + trees[0].num_tokens,
                     "vae_shift_factor": trees[2].shift_factor})
        print(json.dumps(line), flush=True)
    print(json.dumps(compare), flush=True)
    if eager["flash_sdpa_launches_by_head_dim"] != {64: per_call, 512: 1}:
        raise AssertionError(f"sd3: flash launches by head dim "
                             f"{eager['flash_sdpa_launches_by_head_dim']}")
    if not (compare["latent_bit_identical"] and compare["image_bit_identical"]):
        raise AssertionError(f"sd3: the graphed call differs from the eager one "
                             f"(latent rel L2 {compare['latent_rel_l2']})")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    pipe, _ = build_pipeline(trees, "sd3", batch_size=2, use_cuda_graph=False)
    step = step_drive(pipe, "sd3", SD3_STEPS, trees[0].depth)
    del pipe, trees
    gc.collect()
    torch.cuda.empty_cache()
    return eager, graphed, step


def sd35m_phase():
    """One evaluation of the SD3.5-medium transformer geometry at 1024x1024
    (``mmdit_config_from_json`` of its published config.json: 24 blocks of
    24 heads of 64, q/k RMSNorm, dual attention in blocks 0-12, the
    384-token position grid), seeded random bf16 weights, CFG folded (B =
    2), 154 context tokens, the first flow-euler timestep: a finite
    velocity, with the flash kernel 24 + 13 times (d = 64), counted from 0
    just before the measured call (one untimed call first).  Returns its
    line."""
    import torch

    from distrifuser_tpu_torch.models import mmdit
    from distrifuser_tpu_torch.ops import flash_attention as fa
    from distrifuser_tpu_torch.schedulers import get_scheduler

    mcfg = mmdit.mmdit_config_from_json(SD35M_JSON)
    gen = torch.Generator(device="cuda").manual_seed(35)
    params = mmdit.init_mmdit_params(gen, mcfg, torch.bfloat16)
    x = torch.randn(2, mcfg.sample_size, mcfg.sample_size, mcfg.in_channels, device="cuda",
                    generator=gen)
    enc = torch.randn(2, SD3_CONTEXT, mcfg.joint_attention_dim, device="cuda", generator=gen)
    pooled = torch.randn(2, mcfg.pooled_projection_dim, device="cuda", generator=gen)
    t = get_scheduler("flow-euler").set_timesteps(SD3_STEPS).timesteps()[0].cuda()
    launches = mcfg.depth + mcfg.dual_attention_blocks

    def evaluate():
        with torch.inference_mode():
            return mmdit.mmdit_forward(params, mcfg, x, t, enc, pooled)

    evaluate()
    torch.cuda.reset_peak_memory_stats()
    out, secs, counts = counted_call(evaluate, "sd35m", launches)
    by_head_dim = dict(fa.flash_sdpa.launches_by_head_dim)
    line = {"phase": "sd35m_geometry", "config": SD35M_JSON,
            "dual_attention_blocks": mcfg.dual_attention_blocks, "qk_norm": mcfg.qk_norm,
            "shape": list(out.shape), "finite": bool(torch.isfinite(out).all()),
            "ms": secs * 1e3, "flash_sdpa_launches": counts["flash_sdpa"],
            "flash_sdpa_launches_by_head_dim": by_head_dim,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "parameters": _param_count(params)}
    print(json.dumps(line), flush=True)
    if not line["finite"] or by_head_dim != {64: launches}:
        raise AssertionError(f"sd35m geometry: {line}")
    del params, out
    gc.collect()
    torch.cuda.empty_cache()
    return line


def img2img_handoff_phase(pipe, trees):
    """On the dense SDXL pipeline at 1024x1024, eagerly and under CUDA
    graphs: img2img at strength 0.5 of 4 steps (steps 2 and 3 run: 2 x 140
    flash launches, the encoder's 1 and the decoder's 1), graphed equal to
    eager bit for bit; the handoff, a call to ``denoising_end=0.5`` and one
    from ``denoising_start=0.5``, equal to one full call bit for bit in each
    mode; then a refiner-layout UNet (SDXL's widths with the 5-id add
    embedding, its own seeded weights) resumes the graphed base latent, and
    ``aesthetic_score`` changes its image.  Returns the graphed lines."""
    import dataclasses

    import numpy as np
    import torch

    from distrifuser_tpu_torch import DistriConfig, DistriSDXLPipeline
    from distrifuser_tpu_torch.models import unet

    ucfg, _, vcfg, vae_p, tcfgs, text_p = trees
    per_step = unet.attention_calls_per_forward(ucfg)
    image = init_image(1024)
    results, outs = {}, {}
    for mode in ("eager", "graphed"):
        pipe.set_stepwise(mode == "eager")

        def i2i(output_type):
            return pipe(PROMPT, image=image, strength=I2I_STRENGTH,
                        num_inference_steps=I2I_STEPS, seed=0,
                        output_type=output_type).images[0]

        i2i("np")  # a first call picks cuDNN algorithms for the encoder
        img, secs, launches = counted_call(lambda: i2i("np"), f"img2img {mode}",
                                           2 * per_step + 2)
        steps_run = dict(pipe.runner.phase_counts)
        if steps_run != {"sync": 2, "stale": 0}:
            raise AssertionError(f"img2img {mode}: steps by phase {steps_run}")
        if img.shape != (1024, 1024, 3) or not np.isfinite(img).all():
            raise AssertionError(f"img2img {mode}: image {img.shape}")
        outs[mode] = (img, i2i("latent"))
        line = {"phase": "img2img", "run": mode, "height": 1024, "width": 1024,
                "steps": I2I_STEPS, "strength": I2I_STRENGTH, "steps_by_phase": steps_run,
                "total_s": secs, "flash_sdpa_launches": launches["flash_sdpa"],
                "pixel_mean": float((img * 255).round().mean()),
                "image_sha256": image_digest(img)}
        print(json.dumps(line), flush=True)
        results[f"img2img_{mode}"] = line
    same = {"image_bit_identical": bool(np.array_equal(outs["eager"][0], outs["graphed"][0])),
            "latent_bit_identical": bool(np.array_equal(outs["eager"][1], outs["graphed"][1]))}
    print(json.dumps({"phase": "graph_vs_eager", "run": "img2img", **same}), flush=True)
    if not all(same.values()):
        raise AssertionError(f"img2img: graphed differs from eager {same}")

    kw = dict(num_inference_steps=4, seed=0, output_type="latent")
    for mode in ("eager", "graphed"):
        pipe.set_stepwise(mode == "eager")
        full = pipe(PROMPT, **kw).images[0]

        def split():
            first = pipe(PROMPT, denoising_end=HANDOFF_AT, **kw).images[0]
            return first, pipe(PROMPT, latents=first[None], denoising_start=HANDOFF_AT,
                               **kw).images[0]

        (mid, resumed), secs, launches = counted_call(split, f"handoff {mode}", 4 * per_step)
        line = {"phase": "handoff", "run": mode, "height": 1024, "width": 1024, "steps": 4,
                "at": HANDOFF_AT, "total_s": secs,
                "flash_sdpa_launches": launches["flash_sdpa"],
                "split_equals_full_bit_for_bit": bool(np.array_equal(resumed, full)),
                "latent_sha256": image_digest(resumed)}
        print(json.dumps(line), flush=True)
        if not line["split_equals_full_bit_for_bit"]:
            raise AssertionError(f"handoff {mode}: the split differs from the full call")
        results[f"handoff_{mode}"] = line

    rcfg = dataclasses.replace(ucfg, projection_class_embeddings_input_dim=REFINER_PROJ)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1)
    refiner = DistriSDXLPipeline.from_params(
        DistriConfig(height=1024, width=1024), rcfg,
        unet.init_unet_params(gen, rcfg, torch.bfloat16), vcfg, vae_p, tcfgs, text_p)
    init_s = time.perf_counter() - t0

    def resume(**micro):
        return refiner(PROMPT, latents=mid[None], denoising_start=HANDOFF_AT,
                       num_inference_steps=4, seed=0, output_type="np", **micro).images[0]

    resume()  # captures the refiner's graph
    img, secs, launches = counted_call(resume, "refiner", 2 * per_step + 1)
    scored = resume(aesthetic_score=3.0)
    line = {"phase": "refiner", "unet": "sdxl_config widths, 5 time ids "
            f"(projection_class_embeddings_input_dim {REFINER_PROJ}), random bf16 weights",
            "time_ids": int(refiner._encode([PROMPT], [""])[1]["time_ids"].shape[-1]),
            "init_s": init_s, "total_s": secs, "flash_sdpa_launches": launches["flash_sdpa"],
            "finite": bool(np.isfinite(img).all()),
            "aesthetic_score_changes_image": bool(np.abs(scored - img).max() > 0),
            "image_sha256": image_digest(img)}
    print(json.dumps(line), flush=True)
    if not (line["finite"] and line["aesthetic_score_changes_image"] and line["time_ids"] == 5):
        raise AssertionError(f"refiner: {line}")
    results["refiner"] = line
    del refiner
    torch.cuda.empty_cache()
    return results


def tiled_decode_phase(trees):
    """The row-tiled decode: on the card (bf16) against the same code on the
    CPU (float32) at the tiny size (tile 16 of a (1, 32, 8, 4) latent,
    relative L2 <= 8e-2); then a 2048x2048 SDXL latent (1, 256, 256, 4)
    decoded in tiles of 64 rows (5 tiles, a flash launch each) and whole
    (one launch at (1, 65536, 65536, 1, 512)), each timed after one untimed
    call, with its peak memory above what was allocated before it; and the
    2048x2048 pipeline's decoder choice (tiles of 64).  Returns the lines."""
    import numpy as np
    import torch

    from distrifuser_tpu_torch import DistriConfig, DistriSDXLPipeline
    from distrifuser_tpu_torch.models import vae
    from distrifuser_tpu_torch.models.unet import cast_params

    tcfg = vae.tiny_vae_config()
    tparams = vae.init_vae_params(torch.Generator().manual_seed(0), tcfg)
    lat = torch.from_numpy(np.random.RandomState(0).randn(1, 32, 8, 4).astype(np.float32))
    ref = vae.decode(tparams, tcfg, lat, tile=16).numpy()
    got = vae.decode(cast_params(tparams, torch.bfloat16, "cuda"), tcfg,
                     lat.cuda().bfloat16(), tile=16).float().cpu().numpy()
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    tiny = {"phase": "tiled_decode_tiny_check", "latent": [1, 32, 8, 4], "tile": 16,
            "rel_l2": rel, "max_abs": float(np.abs(got - ref).max()),
            "limit_rel_l2": TINY_REL_L2["none"]}
    print(json.dumps(tiny), flush=True)
    if not (np.isfinite(got).all() and rel <= TINY_REL_L2["none"]):
        raise AssertionError(f"tiled decode bf16/card vs fp32/cpu: {tiny}")

    ucfg, unet_p, vcfg, vae_p, tcfgs, text_p = trees
    pipe = DistriSDXLPipeline.from_params(DistriConfig(height=DECODE_SIZE, width=DECODE_SIZE),
                                          ucfg, unet_p, vcfg, vae_p, tcfgs, text_p)
    if pipe.vae_decode_tile != DECODE_TILE:
        raise AssertionError(f"the {DECODE_SIZE}x{DECODE_SIZE} pipeline decodes with "
                             f"tile {pipe.vae_decode_tile}, expected {DECODE_TILE}")
    del pipe
    lh = DECODE_SIZE // 8
    latent = torch.randn(1, lh, lh, 4, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0)).bfloat16()
    lines, images = {}, {}
    for name, tile, launches_want in (("tiled", DECODE_TILE, 5), ("whole", 0, 1)):
        decode = lambda: vae.decode(vae_p, vcfg, latent, tile=tile)  # noqa: E731
        decode()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        img, secs, launches = counted_call(decode, f"decode {name}", launches_want)
        line = {"phase": "decode_2048", "run": name, "latent": [1, lh, lh, 4],
                "tile": tile, "ms": secs * 1e3,
                "peak_allocated_above_base_bytes": torch.cuda.max_memory_allocated() - base,
                "flash_sdpa_launches": launches["flash_sdpa"],
                "finite": bool(torch.isfinite(img).all())}
        if tuple(img.shape) != (1, DECODE_SIZE, DECODE_SIZE, 3) or not line["finite"]:
            raise AssertionError(f"decode {name}: {tuple(img.shape)}, {line}")
        images[name] = img.float().cpu().numpy()[0]
        lines[name] = line
        del img
        torch.cuda.empty_cache()
    # information only: tiling bounds the mid attention to a tile
    diff = np.abs(np.clip(images["tiled"] / 2 + 0.5, 0, 1)
                  - np.clip(images["whole"] / 2 + 0.5, 0, 1))
    lines["tiled"]["median_abs_vs_whole"] = float(np.median(diff))
    for line in lines.values():
        print(json.dumps(line), flush=True)
    return lines


def serve_phase(trees, steps, expected_flash, expected_quant):
    """The serve plane on the card (distrifuser_tpu_torch.serve): an
    InferenceServer over ``pipeline_executor_factory`` building
    DistriSDXLPipeline at batch_size SERVE_BATCH from ``trees`` (1024x1024,
    ``steps`` DDIM steps, CUDA graphs captured by ``prepare`` at warmup).
    Five requests run as batches of 2, 2 and 1 (the last padded), every
    dispatch a cache hit on warmup's executor, each image bit for bit with
    the same pipeline's solo call, ``expected_flash`` flash launches a call.
    A second server's dense executor runs out of memory for real on its
    first call (``torch.cuda.OutOfMemoryError``, which ``is_oom`` must
    see); the ladder's weight_quant_on rung builds the int8 key
    (``apply_key_policy``: the dense tree quantized, re-tagged "pallas",
    then captured) and the retried batch succeeds, each image bit for bit
    with the int8 pipeline's solo call, ``expected_quant`` launches of each
    quant kernel a call.  Returns the phase's result dict (the "serve"
    line) and the launch totals of both servers' dispatches."""
    import numpy as np
    import torch

    from distrifuser_tpu_torch.serve import (InferenceServer, ResilienceConfig, ServeConfig,
                                             is_oom, pipeline_executor_factory)

    size = SIZES["sdxl"]

    class Counted:
        """A served executor, each call's launch counts kept (read before
        and after the call; the dispatches run one at a time)."""

        def __init__(self, ex):
            self.ex, self.calls = ex, []
            self.batch_size, self.shallow_steps = ex.batch_size, ex.shallow_steps
            self.weight_nbytes = ex.weight_nbytes

        def __call__(self, *args):
            before = read_counts()
            out = self.ex(*args)
            after = read_counts()
            self.calls.append({k: after[k] - before[k] for k in after})
            return out

    make = pipeline_executor_factory(_sdxl_build(trees))
    executors = {}

    def factory(key):
        executors[key.short()] = Counted(make(key))
        return executors[key.short()]

    config = ServeConfig(
        buckets=((size, size),), max_batch_size=SERVE_BATCH, cache_capacity=2,
        default_steps=steps, warmup_buckets=((size, size),), quant_compute="pallas",
        batch_window_s=SERVE_WINDOW_S,
        resilience=ResilienceConfig(allow_batch_split=False, allow_stepwise_fallback=False,
                                    allow_weight_quant_on=True, watchdog_timeout_s=600.0))

    def serve(server, requests):
        """Submit ``requests`` to the started ``server``; (results, launches
        while they were served: the dispatches', and a build's if one ran,
        seconds)."""
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        futs = [server.submit(p, height=size, width=size, seed=s) for p, s in requests]
        results = [f.result(timeout=900) for f in futs]
        torch.cuda.synchronize()
        return results, read_counts(), time.perf_counter() - t

    def summed(calls):
        return {k: sum(c[k] for c in calls) for k in calls[0]}

    def solo(pipe, requests, results, label, quant):
        """Each request alone through ``pipe`` (counted): its image against
        the served one, bit for bit."""
        same = []
        for i, ((prompt, seed), r) in enumerate(zip(requests, results)):
            out, _, launches = counted_call(
                lambda: pipe(prompt, seed=seed, num_inference_steps=steps, output_type="np"),
                f"{label} solo {i}", expected_flash)
            if launches["quant_matmul"] != quant or launches["quantize_rows"] != quant:
                raise AssertionError(f"{label} solo {i}: launches {launches}")
            same.append(bool(np.array_equal(out.images[0], r.output)))
        if not all(same):
            raise AssertionError(f"{label}: served images differ from their solo calls {same}")
        return same

    def check_calls(ex, label, quant):
        for call in ex.calls:
            want = {"flash_sdpa": expected_flash, "flash_sdpa_lse": 0, "quant_matmul": quant,
                    "quantize_rows": quant, "dequantize_rows": 0, "all_to_all": 0}
            if call != want:
                raise AssertionError(f"{label}: a dispatch launched {call}, expected {want}")

    def timings(results):
        return [{"queue_wait_s": r.queue_wait_s, "execute_s": r.execute_s, "e2e_s": r.e2e_s,
                 "batch_size": r.batch_size, "cache_hit": r.compile_hit,
                 "degradations": list(r.degradations), "exec_key": r.exec_key}
                for r in results]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # dense: warmup builds and captures the bucket's executor; every
    # dispatch after it hits
    server = InferenceServer(factory, config, model_id="sdxl", scheduler="ddim")
    t = time.perf_counter()
    server.start()
    warmup_s = time.perf_counter() - t
    try:
        results, dense_launches, dense_s = serve(server, SERVE_REQUESTS)
        health, snap = server.health(), server.metrics_snapshot()
    finally:
        server.stop()
    (dense_key, dense), = executors.items()
    sizes = sorted(r.batch_size for r in results)
    if sizes != [1, 2, 2, 2, 2] or len(dense.calls) != 3:
        raise AssertionError(f"serve: batch sizes {sizes}, {len(dense.calls)} dispatches")
    if (snap["cache"]["misses"], snap["cache"]["hits"]) != (1, 3) or not all(
            r.compile_hit for r in results):
        raise AssertionError(f"serve: cache {snap['cache']}, a dispatch built")
    check_calls(dense, "serve dense", 0)
    dense_same = solo(dense.ex.pipeline, SERVE_REQUESTS, results, "serve dense", 0)

    # a real OOM: the dense executor's first call holds SERVE_HELD_BYTES, then
    # asks for twice the card; the ladder answers with the int8 key
    total = torch.cuda.get_device_properties(0).total_memory
    state = {}

    class OomOnce:
        batch_size, shallow_steps = dense.batch_size, dense.shallow_steps
        weight_nbytes = dense.weight_nbytes

        def __call__(self, *args):
            if not state.get("raised"):
                torch.cuda.synchronize()
                state["allocated_before_bytes"] = torch.cuda.memory_allocated()
                held = torch.empty(SERVE_HELD_BYTES, dtype=torch.uint8, device="cuda")
                try:
                    torch.empty(2 * total, dtype=torch.uint8, device="cuda")
                except Exception as exc:
                    state["raised"] = f"{type(exc).__module__}.{type(exc).__qualname__}"
                    state["cuda_oom"] = isinstance(exc, torch.cuda.OutOfMemoryError)
                    state["is_oom"] = is_oom(exc)
                    state["held_bytes"] = held.numel()
                    raise
            return dense(*args)

    def oom_factory(key):
        if key.weight_quant == "none":
            return OomOnce()
        torch.cuda.synchronize()
        state["allocated_at_rebuild_bytes"] = torch.cuda.memory_allocated()
        t = time.perf_counter()
        ex = factory(key)
        state["int8_build_s"] = time.perf_counter() - t
        return ex

    oom_requests = [(f"{PROMPT}, after the OOM #{i}", 200 + i)
                    for i in range(SERVE_OOM_REQUESTS)]
    server = InferenceServer(oom_factory, config, model_id="sdxl", scheduler="ddim")
    server.start()
    try:
        oom_results, int8_launches, int8_s = serve(server, oom_requests)
        oom_health, oom_snap = server.health(), server.metrics_snapshot()
    finally:
        server.stop()
    int8_key = next(k for k in executors if k != dense_key)
    int8 = executors[int8_key]
    if not (state.get("cuda_oom") and state.get("is_oom")):
        raise AssertionError(f"serve: the forced allocation raised {state}")
    rungs = oom_health["degradations"].get(dense_key, {}).get("rungs")
    if rungs != ["weight_quant_on"] or not all(
            r.degradations == ("weight_quant_on",) and r.exec_key == int8_key
            for r in oom_results):
        raise AssertionError(f"serve: ladder {oom_health['degradations']}, results "
                             f"{[(r.degradations, r.exec_key) for r in oom_results]}")
    if not int8_key.endswith(":wq-int8:qc-pallas"):
        raise AssertionError(f"serve: degraded key {int8_key}")
    growth = state["allocated_at_rebuild_bytes"] - state["allocated_before_bytes"]
    if growth > SERVE_MEM_MARGIN:
        raise AssertionError(f"serve: {growth} bytes still allocated when the int8 key "
                             f"rebuilds (margin {SERVE_MEM_MARGIN})")
    check_calls(int8, "serve int8", expected_quant)
    int8_same = solo(int8.ex.pipeline, oom_requests, oom_results, "serve int8", expected_quant)
    line = {
        "model": MODEL_NAMES["sdxl"] + ", random bf16 weights",
        "height": size, "width": size, "steps": steps, "executor_batch_size": SERVE_BATCH,
        "config": {"max_batch_size": config.max_batch_size,
                   "batch_window_s": config.batch_window_s,
                   "cache_capacity": config.cache_capacity,
                   "quant_compute": config.quant_compute},
        "warmup_build_and_capture_s": warmup_s,
        "dense": {"requests": timings(results), "seconds": dense_s,
                  "dispatches": len(dense.calls), "cache": snap["cache"],
                  "launches_per_call": dense.calls[0], "launches": summed(dense.calls),
                  "launches_while_serving": dense_launches,
                  "bit_identical_to_solo": dense_same,
                  "latency_s": snap["latency_s"], "weight_bytes": dense.weight_nbytes},
        "oom": {"raised": state["raised"], "is_oom": state["is_oom"],
                "held_bytes": state["held_bytes"],
                "allocated_before_bytes": state["allocated_before_bytes"],
                "allocated_at_rebuild_bytes": state["allocated_at_rebuild_bytes"],
                "margin_bytes": SERVE_MEM_MARGIN, "ladder_rungs": rungs,
                "degraded_key": int8_key, "int8_build_and_capture_s": state["int8_build_s"],
                "requests": timings(oom_results), "seconds": int8_s,
                "dispatches": len(int8.calls), "cache": oom_snap["cache"],
                "counters": oom_snap["requests"], "launches_per_call": int8.calls[0],
                "launches": summed(int8.calls),
                "launches_while_serving_incl_the_int8_build": int8_launches,
                "bit_identical_to_solo": int8_same,
                "health_status": oom_health["status"],
                "last_error": oom_health["last_errors"][-1]["message"][:300],
                "weight_bytes": int8.weight_nbytes},
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "max_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
    }
    del dense, int8, executors
    gc.collect()
    torch.cuda.empty_cache()
    return line

def _counted_round(fn):
    """``fn()`` between two reads of the launch counts, the card
    synchronised around it: (result, ms, launches)."""
    import torch

    torch.cuda.synchronize()
    before = read_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    after = read_counts()
    return out, ms, {k: after[k] - before[k] for k in after}


def _histograms(snap):
    """count / mean / p50 / p99 of a LatencyHistogram snapshot."""
    return {k: snap.get(k) for k in ("count", "mean", "p50", "p99")}


def staged_phase(trees, steps, expected_flash):
    """The staged serve path on the card (serve/staging.py): an
    InferenceServer with ``pipeline_stages=True``, ``max_inflight_batches``
    STAGED_INFLIGHT and a prompt cache of STAGED_PROMPT_CACHE entries over
    ``pipeline_executor_factory`` (the serve phase's DistriSDXLPipeline at
    batch_size SERVE_BATCH from ``trees``, 1024x1024, ``steps`` DDIM steps,
    graphs captured at warmup, before the stage workers run).  The six
    STAGED_REQUESTS run as three batches of 2, the third the first one again
    (a prompt-cache hit); each image equals the same pipeline's solo call
    bit for bit; ``expected_flash`` flash launches a dispatch.  Each stage
    runs on a CUDA stream of its own.  Returns the "staged" line: per-stage
    queue wait and service seconds, the denoise-gap fraction, the prompt
    cache, launches a dispatch, memory."""
    import numpy as np
    import torch

    from distrifuser_tpu_torch.serve import (InferenceServer, ResilienceConfig, ServeConfig,
                                             pipeline_executor_factory)

    size = SIZES["sdxl"]

    make, built = pipeline_executor_factory(_sdxl_build(trees)), []

    def factory(key):
        built.append(make(key))
        return built[-1]

    config = ServeConfig(
        buckets=((size, size),), max_batch_size=SERVE_BATCH, default_steps=steps,
        warmup_buckets=((size, size),), batch_window_s=SERVE_WINDOW_S,
        pipeline_stages=True, max_inflight_batches=STAGED_INFLIGHT,
        prompt_cache_capacity=STAGED_PROMPT_CACHE,
        resilience=ResilienceConfig(watchdog_timeout_s=600.0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    server = InferenceServer(factory, config, model_id="sdxl", scheduler="ddim")
    t = time.perf_counter()
    server.start()
    warmup_s = time.perf_counter() - t
    torch.cuda.synchronize()
    reserved_warm = torch.cuda.memory_reserved()
    try:
        (results, snap), seconds_ms, launches = _counted_round(lambda: (
            [f.result(timeout=900) for f in
             [server.submit(p, height=size, width=size, seed=s)
              for p, s in STAGED_REQUESTS]],
            server.metrics_snapshot()))
        health = server.health()
    finally:
        server.stop()
    (ex,) = built
    staging = snap["staging"]
    dispatches = staging["completed"]
    if (dispatches != len(STAGED_REQUESTS) // SERVE_BATCH or staging["failed"]
            or staging["submitted"] != dispatches):
        raise AssertionError(f"staged: {staging['submitted']} submitted, {dispatches} "
                             f"completed, {staging['failed']} failed")
    if sorted(r.batch_size for r in results) != [2] * len(STAGED_REQUESTS):
        raise AssertionError(f"staged: batch sizes {[r.batch_size for r in results]}")
    want = {"flash_sdpa": dispatches * expected_flash, "flash_sdpa_lse": 0,
            "quant_matmul": 0, "quantize_rows": 0, "dequantize_rows": 0, "all_to_all": 0}
    if launches != want:
        raise AssertionError(f"staged: launches {launches}, expected {want}")
    cache = snap["prompt_cache"]
    if (cache["hits"], cache["misses"]) != (1, 2):
        raise AssertionError(f"staged: prompt cache {cache}")
    pipe = ex.pipeline
    same = []
    for (prompt, seed), r in zip(STAGED_REQUESTS, results):
        out, _, _ = counted_call(
            lambda: pipe(prompt, seed=seed, num_inference_steps=steps, output_type="np"),
            f"staged solo {prompt}", expected_flash)
        same.append(bool(np.array_equal(out.images[0], r.output)))
    if not all(same):
        raise AssertionError(f"staged: served images differ from their solo calls {same}")
    line = {
        "model": MODEL_NAMES["sdxl"] + ", random bf16 weights",
        "height": size, "width": size, "steps": steps, "executor_batch_size": SERVE_BATCH,
        "config": {"max_batch_size": SERVE_BATCH, "max_inflight_batches": STAGED_INFLIGHT,
                   "prompt_cache_capacity": STAGED_PROMPT_CACHE,
                   "batch_window_s": SERVE_WINDOW_S},
        "streams": "encode, denoise and decode each on a CUDA stream of its own",
        "warmup_build_and_capture_s": warmup_s,
        "reserved_growth_at_warmup_bytes": reserved_warm - reserved0,
        "seconds": seconds_ms / 1e3, "dispatches": dispatches,
        "flash_launches_per_dispatch": launches["flash_sdpa"] / dispatches,
        "launches": launches,
        "stages": {stage: {"queue_wait_s": _histograms(v["queue_wait"]),
                           "service_s": _histograms(v["service"])}
                   for stage, v in staging["stages"].items()},
        "denoise_gap": staging["denoise_gap"],
        "peak_inflight": staging["peak_inflight"],
        "prompt_cache": cache, "bit_identical_to_solo": same,
        "requests": [{"queue_wait_s": r.queue_wait_s, "execute_s": r.execute_s,
                      "e2e_s": r.e2e_s, "batch_size": r.batch_size} for r in results],
        "health_status": health["status"],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "max_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
    }
    print(json.dumps({"staged": line}), flush=True)
    del ex, pipe, built
    gc.collect()
    torch.cuda.empty_cache()
    return line


class _RoundLog:
    """A step executor whose every ``step_run`` is timed and its launches
    read (``_counted_round``); everything else is the executor's."""

    def __init__(self, ex):
        self.ex, self.rounds = ex, []

    def __getattr__(self, name):
        return getattr(self.ex, name)

    def step_run(self, works):
        _, ms, launches = _counted_round(lambda: self.ex.step_run(works))
        self.rounds.append({"members": len(works), **self.ex.step_pack_stats,
                            "ms": ms, "launches": launches})


def _rounds_by_width(rounds):
    """Mean round ms and launches by (members, dispatches) of the rounds."""
    out = {}
    for r in rounds:
        key = f"{r['members']} members in {r['dispatches']} dispatches"
        e = out.setdefault(key, {"rounds": 0, "ms": [], "launches": r["launches"]})
        e["rounds"] += 1
        e["ms"].append(r["ms"])
    for e in out.values():
        e["mean_ms"] = sum(e["ms"]) / len(e["ms"])
    return out


def step_phase(trees, steps=STEP_STEPS):
    """Step-level continuous batching on the card (serve/stepbatch.py): an
    InferenceServer with ``step_batching`` (STEP_SLOTS slots, a preview
    every STEP_PREVIEW steps) over ``pipeline_executor_factory`` building
    the serve phase's SDXL pipeline at batch_size SERVE_BATCH from
    ``trees``; the key's ``exec_mode="step"`` runs the UNet eagerly, each
    request's carry held by the executor.  Two requests start together (one
    packed dispatch a round), two join while they denoise (packed at other
    step indices), and a fifth arrives with a deadline that only a
    preemption can meet: the slackest slot parks (its carry to the host)
    and resumes later.  Every image equals the same pipeline's solo call
    bit for bit; the metrics must show packing (fewer dispatches than
    request steps, never a sequential fallback).  Then one carry exported
    from a packed round is imported into a fresh executor and finished
    there, bit-equal; and a second server at the int8 key (quantized
    tree, "pallas") packs two requests: quant_matmul and quantize_rows
    launches a packed round.  Returns the "step" line."""
    import numpy as np
    import torch

    from distrifuser_tpu_torch.models.unet import linear_calls
    from distrifuser_tpu_torch.serve import (InferenceServer, PipelineExecutor,
                                             decode_snapshot, encode_snapshot,
                                             pipeline_executor_factory)

    ucfg = trees[0]
    size = SIZES["sdxl"]
    per_eval = 140  # SDXL: flash launches a UNet evaluation

    make, built = pipeline_executor_factory(_sdxl_build(trees)), []

    def factory(key):
        built.append(_RoundLog(make(key)))
        return built[-1]

    previews = {}

    def on_progress(prompt):
        return lambda step, total, img: previews.setdefault(prompt, []).append(
            (step, total, tuple(img.shape)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    server = InferenceServer(factory, _step_config(steps), model_id="sdxl", scheduler="ddim")
    t = time.perf_counter()
    server.start()
    warmup_s = time.perf_counter() - t
    (log,) = built
    try:
        reset_counts()
        t = time.perf_counter()
        submit = lambda req, **kw: server.submit(  # noqa: E731
            req[0], height=size, width=size, seed=req[1], on_progress=on_progress(req[0]),
            **kw)
        futs = [submit(r) for r in STEP_REQUESTS[:2]]
        sb = server.stepbatch
        _wait(lambda: any(s.steps_done >= 1 for s in sb.occupied()), "the first step")
        futs += [submit(r) for r in STEP_REQUESTS[2:4]]  # join mid-denoise
        _wait(lambda: log.rounds and log.rounds[-1]["members"] == STEP_SLOTS,
             "a round of the full pool")
        # a deadline that waiting out the earliest free slot would miss but
        # admission now meets (serve/server.py _step_preempt), checked after
        # the round now running: the server's per-step estimate (an EWMA of
        # the round times, StepBatcher.note_round) will include this round,
        # about as long as the last one, and the slots' fewest remaining
        # steps will be one less than now
        r = log.rounds[-1]["ms"] / 1e3
        ewma = None
        for rnd in log.rounds:
            ewma = rnd["ms"] / 1e3 if ewma is None else 0.8 * ewma + 0.2 * rnd["ms"] / 1e3
        per_step = 0.8 * ewma + 0.2 * r
        min_rem = min(s.remaining for s in sb.occupied())
        ttl = r + (steps + (min_rem - 1) / 2) * per_step
        futs.append(submit(STEP_REQUESTS[4], ttl_s=ttl))
        results = [f.result(timeout=900) for f in futs]
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t
        serve_launches = read_counts()
        snap, slo = server.metrics_snapshot(), server.slo_snapshot()
    finally:
        server.stop()
    ex = log.ex
    reqs = snap["requests"]
    packed = [r for r in log.rounds if r["packed_rows"] > r["dispatches"]]
    if not packed or reqs["stepbatch_packed_rows"] <= reqs["stepbatch_dispatches"]:
        raise AssertionError(f"step: no packed dispatch ({reqs})")
    if reqs["steps_executed"] != steps * len(STEP_REQUESTS):
        raise AssertionError(f"step: {reqs['steps_executed']} request steps")
    for r in log.rounds:
        if r["launches"]["flash_sdpa"] != per_eval * r["dispatches"]:
            raise AssertionError(f"step: a round launched {r['launches']}")
    preempts = [r.preempts for r in results]
    if sum(preempts) != 1 or snap["step_batching"]["preempts"] != 1:
        raise AssertionError(f"step: preempts {preempts}, "
                             f"{snap['step_batching']['preempts']} in the pool")
    pipe = ex.pipeline
    same = []
    for (prompt, seed), r in zip(STEP_REQUESTS, results):
        out, _, _ = counted_call(
            lambda: pipe(prompt, seed=seed, num_inference_steps=steps, output_type="np"),
            f"step solo {prompt}", steps * per_eval + 1)
        same.append(bool(np.array_equal(out.images[0], r.output)))
    if not all(same):
        raise AssertionError(f"step: served images differ from their solo calls {same}")
    want_previews = [(k, steps, None) for k in range(STEP_PREVIEW, steps + 1, STEP_PREVIEW)]
    for prompt, _ in STEP_REQUESTS:
        got = [(a, b, None) for a, b, _ in previews.get(prompt, [])]
        if got != want_previews:
            raise AssertionError(f"step: previews of {prompt!r}: {previews.get(prompt)}")

    # one carry exported from a packed round, finished in a fresh executor
    key = ex.key
    (pa, sa), (pb, sb_) = STEP_REQUESTS[:2]
    wa, wb = ex.step_begin(pa, "", sa, 5.0), ex.step_begin(pb, "", sb_, 5.0)
    ex.step_run([wa, wb])
    ex.step_run([wa, wb])
    if ex.step_pack_stats != {"dispatches": 1, "packed_rows": 2, "rows_capacity": 2}:
        raise AssertionError(f"step export: the round was not packed {ex.step_pack_stats}")
    extra, leaves = ex.step_export(wb)
    ex.step_abort(wb)
    data = encode_snapshot(ekey=key, family=extra.pop("family"), step=extra.pop("step"),
                           steps_total=steps, request_id="export", prompt=pb, seed=sb_,
                           leaves=leaves, extra=extra)
    snap_in = decode_snapshot(data)
    fresh = PipelineExecutor(pipe, steps, key=key)
    wb2 = fresh.step_import(snap_in.meta, list(snap_in.leaves), pb, "", sb_, 5.0)
    while not fresh.step_done(wb2):
        fresh.step_run([wb2])
    while not ex.step_done(wa):
        ex.step_run([wa])
    migrated = {"snapshot_bytes": len(data), "leaves": len(leaves),
                "imported_equals_served": bool(np.array_equal(fresh.step_finish(wb2),
                                                              results[1].output)),
                "exporter_equals_served": bool(np.array_equal(ex.step_finish(wa),
                                                              results[0].output))}
    if not (migrated["imported_equals_served"] and migrated["exporter_equals_served"]):
        raise AssertionError(f"step export: {migrated}")
    del fresh, wa, wb, wb2

    # the int8 key: quant_matmul and quantize_rows launches a packed round
    per_forward, per_call = linear_calls(ucfg)
    server = InferenceServer(factory, _step_config(steps, weight_quant="int8",
                                                   quant_compute="pallas"),
                             model_id="sdxl", scheduler="ddim")
    server.start()
    try:
        futs = [server.submit(p, height=size, width=size, seed=s) for p, s in
                STEP_INT8_REQUESTS]
        int8_results = [f.result(timeout=900) for f in futs]
        int8_snap = server.metrics_snapshot()
    finally:
        server.stop()
    int8_log = built[-1]
    int8_packed = [r for r in int8_log.rounds if r["packed_rows"] == 2 and r["dispatches"] == 1]
    for r in int8_log.rounds:
        # an evaluation's linears, and the text KV the step recomputes
        want = r["dispatches"] * (per_forward + per_call)
        if (r["launches"]["quant_matmul"], r["launches"]["quantize_rows"]) != (want, want):
            raise AssertionError(f"step int8: a round launched {r['launches']}")
    if not int8_packed:
        raise AssertionError(f"step int8: no packed round {int8_log.rounds}")
    int8_pipe = int8_log.ex.pipeline
    int8_same = []
    for (prompt, seed), r in zip(STEP_INT8_REQUESTS, int8_results):
        out = int8_pipe(prompt, seed=seed, num_inference_steps=steps, output_type="np")
        int8_same.append(bool(np.array_equal(out.images[0], r.output)))
    if not all(int8_same):
        raise AssertionError(f"step int8: served images differ from solo calls {int8_same}")
    line = {
        "model": MODEL_NAMES["sdxl"] + ", random bf16 weights",
        "height": size, "width": size, "steps": steps, "executor_batch_size": SERVE_BATCH,
        "config": {"slots": STEP_SLOTS, "preview_interval": STEP_PREVIEW},
        "eager": "exec_mode='step' runs the UNet eagerly (set_stepwise): no graphs held",
        "warmup_build_s": warmup_s, "seconds": serve_s,
        "requests": [{"queue_wait_s": r.queue_wait_s, "execute_s": r.execute_s,
                      "e2e_s": r.e2e_s, "first_preview_s": r.first_preview_s,
                      "previews": r.previews, "preempts": r.preempts} for r in results],
        "counters": {k: reqs.get(k) for k in (
            "steps_executed", "stepbatch_dispatches", "stepbatch_packed_rows",
            "step_joins", "step_preempts", "step_resumes", "step_previews")},
        "pool": snap["step_batching"], "slo_step": slo.get("step"),
        "first_preview_s": [r.first_preview_s for r in results],
        "rounds_by_width": _rounds_by_width(log.rounds),
        "rounds": len(log.rounds), "launches_while_serving": serve_launches,
        "bit_identical_to_solo": same, "migration": migrated,
        "dispatches": sum(r["dispatches"] for r in log.rounds),
        "finishes": len(results),
        "int8": {"rounds_by_width": _rounds_by_width(int8_log.rounds),
                 "dispatches": sum(r["dispatches"] for r in int8_log.rounds),
                 "quant_matmul_launches": sum(r["launches"]["quant_matmul"]
                                              for r in int8_log.rounds),
                 "quantize_rows_launches": sum(r["launches"]["quantize_rows"]
                                               for r in int8_log.rounds),
                 "counters": {k: int8_snap["requests"].get(k) for k in (
                     "stepbatch_dispatches", "stepbatch_packed_rows")},
                 "quant_launches_per_dispatch": per_forward + per_call,
                 "bit_identical_to_solo": int8_same},
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "max_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
    }
    print(json.dumps({"step": line}), flush=True)
    del ex, pipe, int8_pipe, built, log, int8_log
    gc.collect()
    torch.cuda.empty_cache()
    return line


class _StepRounds:
    """A step executor whose every ``step_run`` keeps its host-clock start
    and end and its dispatches; no launch reads (a fleet's other replica
    launches on its own thread meanwhile).  Everything else is the
    executor's."""

    def __init__(self, ex):
        self.ex, self.rounds = ex, []

    def __getattr__(self, name):
        return getattr(self.ex, name)

    def step_run(self, works):
        t0 = time.monotonic()
        self.ex.step_run(works)
        self.rounds.append({"t0": t0, "t1": time.monotonic(), "members": len(works),
                            **self.ex.step_pack_stats})


def _sdxl_build(trees, tier_knobs=False, **fields):
    """The serve phases' build function: DistriSDXLPipeline at batch_size
    SERVE_BATCH from ``trees`` on this card (bf16) at the key's size, CFG
    and scheduler, with ``fields`` of DistriConfig; with ``tier_knobs`` also
    the key's step cache, wire compression and refresh fraction (the SLO
    controller's tiers)."""
    from distrifuser_tpu_torch import DistriConfig, DistriSDXLPipeline

    ucfg, unet_p, vcfg, vae_p, tcfgs, text_p = trees

    def build(key):
        knobs = dict(step_cache_interval=key.step_cache_interval,
                     step_cache_depth=key.step_cache_depth,
                     comm_compress=key.comm_compress,
                     refresh_fraction=key.refresh_fraction) if tier_knobs else {}
        cfg = DistriConfig(height=key.height, width=key.width, batch_size=SERVE_BATCH,
                           do_classifier_free_guidance=key.cfg, **fields, **knobs)
        return DistriSDXLPipeline.from_params(cfg, ucfg, unet_p, vcfg, vae_p, tcfgs, text_p,
                                              scheduler=key.scheduler)

    return build


def _step_config(steps, **fields):
    """ServeConfig of the step-batching phases: SDXL 1024x1024, executors at
    batch_size SERVE_BATCH, STEP_SLOTS slots, a preview every STEP_PREVIEW
    steps, ``steps`` DDIM steps a request, ``fields`` besides."""
    from distrifuser_tpu_torch.serve import ResilienceConfig, ServeConfig, StepBatchConfig

    size = SIZES["sdxl"]
    fields.setdefault("resilience", ResilienceConfig(watchdog_timeout_s=600.0))
    return ServeConfig(
        buckets=((size, size),), max_batch_size=SERVE_BATCH, default_steps=steps,
        warmup_buckets=((size, size),), default_ttl_s=600.0,
        step_batching=StepBatchConfig(enabled=True, slots=STEP_SLOTS,
                                      preview_interval=STEP_PREVIEW,
                                      step_service_prior_s=0.5), **fields)


def _step_flash(trees, logs, finishes):
    """(dispatches, the flash launches they and ``finishes`` decodes make)
    of step executors' round logs: a UNet evaluation's attention a
    dispatch (140 for SDXL), one launch a decode."""
    from distrifuser_tpu_torch.models.unet import attention_calls_per_forward

    n = sum(r["dispatches"] for log in logs for r in log.rounds)
    return n, n * attention_calls_per_forward(trees[0]) + finishes


def _solo_same(pipe, requests, outputs, steps):
    """Each (prompt, seed) alone through ``pipe``: its image against the
    served one, bit for bit (comparison launches, outside the counts)."""
    import numpy as np

    return [bool(np.array_equal(pipe(p, seed=s, num_inference_steps=steps,
                                      output_type="np").images[0], np.asarray(out)))
            for (p, s), out in zip(requests, outputs)]


def _wait(cond, what, timeout=600.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def controller_phase(trees, steps):
    """The closed-loop SLO controller on the card (serve/controller.py): an
    InferenceServer with ``controller.enabled`` over whole-batch executors
    at batch_size SERVE_BATCH (graphed), the default class held to a p99
    target (CTRL_TARGET_S) far below a dispatch.  The build function reads
    each tier key's knobs (step cache, wire compression, refresh fraction;
    warmup CTRL_WARMUP, so the step cache's tiers run shallow steps); every
    tier key of the default table is built before the burst.  CTRL_REQUESTS
    walk the class one rung a dispatch to ``reduced_steps`` and on into
    admission control: the next submission raises AdmissionRejectedError.
    The operator then relaxes the target; the idle server retracts to full
    and serves CTRL_AFTER there.  Each dispatch's flash launches against its
    tier's plan (a full step 140, a shallow step the shallow levels', the
    decode 1), every image against its tier key's solo call bit for bit.
    Returns (the "controller" line, the flash path's row weights)."""
    import dataclasses

    import torch

    from distrifuser_tpu_torch.models.unet import transformer_blocks_per_level
    from distrifuser_tpu_torch.serve import (ADMISSION, AdmissionRejectedError,
                                             ControllerConfig, InferenceServer,
                                             ResilienceConfig, ServeConfig, apply_tier,
                                             pipeline_executor_factory)

    size = SIZES["sdxl"]
    blocks = transformer_blocks_per_level(trees[0])
    levels = len(blocks)
    calls = []

    class Counted:
        """A tier key's executor, each call's launches and host seconds kept
        (the dispatches run one at a time on the scheduler thread)."""

        def __init__(self, ex):
            self.ex = ex
            self.batch_size, self.shallow_steps = ex.batch_size, ex.shallow_steps
            self.weight_nbytes = ex.weight_nbytes

        def __call__(self, *args):
            before, t = read_counts(), time.perf_counter()
            out = self.ex(*args)
            after = read_counts()
            calls.append({"key": self.ex.key.short(), "s": time.perf_counter() - t,
                          "launches": {k: after[k] - before[k] for k in after}})
            return out

    make = pipeline_executor_factory(_sdxl_build(trees, tier_knobs=True,
                                                 warmup_steps=CTRL_WARMUP))
    executors = {}

    def factory(key):
        executors[key.short()] = Counted(make(key))
        return executors[key.short()]

    config = ServeConfig(
        buckets=((size, size),), max_batch_size=SERVE_BATCH, cache_capacity=8,
        default_steps=steps, warmup_buckets=((size, size),), batch_window_s=0.1,
        default_ttl_s=600.0,
        controller=ControllerConfig(enabled=True, slo_p99_s={"default": CTRL_TARGET_S},
                                    escalate_cooldown_s=CTRL_COOLDOWN_S,
                                    retract_cooldown_s=CTRL_COOLDOWN_S,
                                    service_prior_s=CTRL_PRIOR_S),
        resilience=ResilienceConfig(allow_batch_split=False, allow_stepwise_fallback=False,
                                    watchdog_timeout_s=600.0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    server = InferenceServer(factory, config, model_id="sdxl", scheduler="ddim")
    t = time.perf_counter()
    server.start()
    warmup_s = time.perf_counter() - t
    ctl = server.controller
    base = server._exec_key_for(size, size, steps, cfg=True)
    tier_of, builds = {}, {}
    try:
        for tier in ctl.tiers:  # every tier key built (and captured) before the burst
            key = apply_tier(base, tier)
            tier_of[key.short()] = tier.name
            t = time.perf_counter()
            server.cache.get(key)
            builds[tier.name] = time.perf_counter() - t
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        futs = [server.submit(p, height=size, width=size, seed=s) for p, s in CTRL_REQUESTS]
        results = [f.result(timeout=900) for f in futs]
        burst_s = time.perf_counter() - t
        at_burst_end = ctl.snapshot()["classes"]["default"]
        if at_burst_end["tier_name"] != ADMISSION:
            raise AssertionError(f"controller: the burst ended at {at_burst_end}")
        try:
            server.submit(f"{PROMPT}, past the last tier", height=size, width=size, seed=1)
        except AdmissionRejectedError as exc:
            rejected = f"{type(exc).__name__}: {exc}"
        else:
            raise AssertionError("controller: a submission passed admission control")
        # the idle spell under the relaxed target: one rung a cooldown to full
        ctl.config = dataclasses.replace(ctl.config, slo_p99_s={"default": CTRL_RELAXED_S})
        t = time.perf_counter()
        _wait(lambda: ctl.snapshot()["classes"]["default"]["tier"] == 0,
              "the controller's retraction", 60.0)
        retract_s = time.perf_counter() - t
        after = [f.result(timeout=900) for f in
                 [server.submit(p, height=size, width=size, seed=s) for p, s in CTRL_AFTER]]
        torch.cuda.synchronize()
        launches = read_counts()
        snap = server.metrics_snapshot()
        transitions = server.registry.counter("serve_controller_transitions").snapshot()
        dispatched = server.registry.counter("serve_controller_dispatches").snapshot()
    finally:
        server.stop()
    walk = [tier_of[c["key"]] for c in calls]
    order = [t.name for t in ctl.tiers]
    burst_walk = [order.index(name) for name in walk[:len(walk) - len(after) // SERVE_BATCH]]
    if walk[0] != "full" or "reduced_steps" not in walk or burst_walk != sorted(burst_walk):
        raise AssertionError(f"controller: the dispatches walked {walk}")
    if walk[-1] != "full" or not all(r.tier == "full" for r in after):
        raise AssertionError(f"controller: after the idle spell {walk}")
    plans, weights = {}, {}
    for c in calls:
        ex = executors[c["key"]].ex
        key, shallow = ex.key, ex.shallow_steps
        depth = key.step_cache_depth if shallow else 0
        evals = [key.steps - shallow + (shallow if lvl < levels - depth else 0)
                 for lvl in range(levels)]
        want = sum(2 * blocks[lvl] * evals[lvl] for lvl in range(levels)) + 1
        plans[tier_of[c["key"]]] = {"steps": key.steps, "shallow_steps": shallow,
                                    "flash_per_dispatch": want}
        if c["launches"]["flash_sdpa"] != want or c["launches"]["quant_matmul"]:
            raise AssertionError(f"controller: a {tier_of[c['key']]} dispatch launched "
                                 f"{c['launches']}, its plan {want}")
        for lvl in range(levels):
            for kind in ("self", "cross"):
                name = f"unet_{kind}_l{lvl}"
                weights[name] = weights.get(name, 0) + evals[lvl] / steps
        weights["vae_mid"] = weights.get("vae_mid", 0) + 1
    if sum(c["launches"]["flash_sdpa"] for c in calls) != launches["flash_sdpa"]:
        raise AssertionError(f"controller: {launches} read, the dispatches {calls}")
    for r in results + after:
        if r.tier != tier_of[r.exec_key]:
            raise AssertionError(f"controller: a result at {r.tier}, key {r.exec_key}")
    same = [_solo_same(executors[r.exec_key].ex.pipeline, [req], [r.output],
                       executors[r.exec_key].ex.steps)[0]
            for req, r in zip(CTRL_REQUESTS + CTRL_AFTER, results + after)]
    if not all(same):
        raise AssertionError(f"controller: served images differ from their tier key's "
                             f"solo calls {same}")
    by_tier = {}
    for c in calls:
        by_tier.setdefault(tier_of[c["key"]], []).append(c["s"])
    line = {
        "model": MODEL_NAMES["sdxl"] + ", random bf16 weights",
        "height": size, "width": size, "steps": steps, "executor_batch_size": SERVE_BATCH,
        "warmup_steps": CTRL_WARMUP,
        "config": {"slo_p99_s": CTRL_TARGET_S, "relaxed_slo_p99_s": CTRL_RELAXED_S,
                   "escalate_cooldown_s": CTRL_COOLDOWN_S,
                   "retract_cooldown_s": CTRL_COOLDOWN_S, "service_prior_s": CTRL_PRIOR_S},
        "warmup_build_and_capture_s": warmup_s, "tier_build_and_capture_s": builds,
        "walk": walk, "transitions": transitions, "dispatches_by_tier": dispatched,
        "dispatch_s_by_tier": by_tier, "plans": plans, "burst_s": burst_s,
        "at_burst_end": at_burst_end, "admission_rejected": rejected[:200],
        "retract_to_full_s": retract_s,
        "service_estimate_s": snap["controller"]["service_estimate_s"],
        "requests": [{"tier": r.tier, "execute_s": r.execute_s, "e2e_s": r.e2e_s,
                      "batch_size": r.batch_size} for r in results + after],
        "dispatches": len(calls), "launches_while_serving": launches,
        "bit_identical_to_tier_solo": same,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "max_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
    }
    print(json.dumps({"controller": line}), flush=True)
    del executors, calls
    gc.collect()
    torch.cuda.empty_cache()
    return line, weights


def _post(url, body, timeout=600):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _read_sse(url, timeout=600):
    """One SSE stream drained: [(event, data)]."""
    import urllib.request

    events, name = [], None
    with urllib.request.urlopen(url, timeout=timeout) as r:
        for raw in r:
            text = raw.decode().rstrip("\n")
            if text.startswith("event: "):
                name = text[7:]
            elif text.startswith("data: "):
                events.append((name, json.loads(text[6:])))
    return events


def gateway_phase(trees, steps=STEP_STEPS):
    """The HTTP/SSE gateway and tenancy on the card (serve/gateway.py,
    serve/tenancy.py): a step-batching server (the step phase's executors)
    behind ``gateway.port=0`` on 127.0.0.1 with two tenants.  One request
    alone over the wire, its SSE stream read to the end (previews at every
    STEP_PREVIEW steps, then the final image), then the same request through
    ``submit`` in process (the two e2e times); four requests of both
    tenants together, bulk's third refused with a 429 (its token bucket),
    a fifth cancelled while queued (its stream ends "cancelled"), a status
    poll.  Every final image decoded from the wire equals the in-process
    result and the solo call bit for bit.  Returns (the "gateway" line,
    the flash path's row weights)."""
    import urllib.error

    import numpy as np
    import torch

    from distrifuser_tpu_torch.serve import (GatewayConfig, InferenceServer, TenantConfig,
                                             decode_image, pipeline_executor_factory)

    size = SIZES["sdxl"]
    make, logs = pipeline_executor_factory(_sdxl_build(trees)), []

    def factory(key):
        logs.append(_StepRounds(make(key)))
        return logs[-1]

    tenants = (TenantConfig(name="interactive", weight=4.0),
               TenantConfig(name="bulk", weight=1.0, rate_rps=GATEWAY_BULK_RATE,
                            burst=GATEWAY_BULK_BURST))
    config = _step_config(steps, gateway=GatewayConfig(port=0, host="127.0.0.1",
                                                       tenants=tenants))
    server = InferenceServer(factory, config, model_id="sdxl", scheduler="ddim")
    server.start()
    gw = server.gateway_endpoint
    url = gw.url

    def body(prompt, seed, tenant):
        return {"prompt": prompt, "seed": seed, "steps": steps, "height": size,
                "width": size, "tenant": tenant}

    try:
        if not url.startswith("http://127.0.0.1:"):
            raise AssertionError(f"gateway: bound at {url}")
        torch.cuda.synchronize()
        reset_counts()
        # one request alone over the wire, then the same in process
        prompt, seed = GATEWAY_ALONE
        t = time.perf_counter()
        status, sub = _post(url + "/v1/generate", body(prompt, seed, "interactive"))
        alone_events = _read_sse(url + sub["events"])
        wire_s = time.perf_counter() - t
        alone_inproc = gw._get(sub["id"]).future.result()
        t = time.perf_counter()
        ref = server.submit(prompt, height=size, width=size, seed=seed,
                            tenant="interactive").result(timeout=900)
        submit_s = time.perf_counter() - t
        # four of both tenants together, bulk over its quota, one cancelled
        subs = [_post(url + "/v1/generate", body(p, s, tn))[1] for p, s, tn in GATEWAY_REQUESTS]
        try:
            _post(url + "/v1/generate", body(f"{PROMPT}, over the quota", 730, "bulk"))
        except urllib.error.HTTPError as exc:
            quota = {"status": exc.code, **json.loads(exc.read())}
        else:
            raise AssertionError("gateway: bulk's third request was admitted")
        _, victim = _post(url + "/v1/generate",
                          body(f"{PROMPT}, cancelled", 740, "interactive"))
        _, cancel = _post(url + f"/v1/requests/{victim['id']}/cancel", {})
        victim_events = _read_sse(url + victim["events"])
        streams = [_read_sse(url + s["events"]) for s in subs]
        inproc = [gw._get(s["id"]).future.result() for s in subs]
        torch.cuda.synchronize()
        launches = read_counts()
        import urllib.request

        with urllib.request.urlopen(url + subs[0]["poll"], timeout=60) as r:
            polled = json.loads(r.read())
        snap = server.metrics_snapshot()
    finally:
        server.stop()
    if status != 202 or quota["status"] != 429 or quota["error"] != "TenantQuotaError":
        raise AssertionError(f"gateway: statuses {status}, {quota}")
    if not cancel["cancelled"] or victim_events[-1][0] != "cancelled":
        raise AssertionError(f"gateway: cancel {cancel}, {victim_events}")
    if polled["status"] != "completed":
        raise AssertionError(f"gateway: status poll {polled}")
    finals = []
    for events in [alone_events] + streams:
        names = [n for n, _ in events]
        want = ["queued"] + ["preview"] * (steps // STEP_PREVIEW) + ["final"]
        if names != want:
            raise AssertionError(f"gateway: a stream's events {names}")
        finals.append(decode_image(events[-1][1]))
    inprocs = [alone_inproc.output] + [r.output for r in inproc]
    wire_same = [bool(a.dtype == np.asarray(b).dtype and a.tobytes() == np.asarray(b).tobytes())
                 for a, b in zip(finals, inprocs)]
    ref_same = bool(finals[0].tobytes() == np.asarray(ref.output).tobytes())
    requests = [GATEWAY_ALONE] + [(p, s) for p, s, _ in GATEWAY_REQUESTS]
    solo = _solo_same(logs[0].ex.pipeline, requests, finals, steps)
    if not (all(wire_same) and ref_same and all(solo)):
        raise AssertionError(f"gateway: wire vs in-process {wire_same}, vs submit {ref_same},"
                             f" vs solo {solo}")
    finishes = len(requests) + 1  # and the in-process submit
    dispatches, flash = _step_flash(trees, logs, finishes)
    if launches["flash_sdpa"] != flash:
        raise AssertionError(f"gateway: {launches} read, {dispatches} dispatches and "
                             f"{finishes} decodes make {flash}")
    line = {
        "model": MODEL_NAMES["sdxl"] + ", random bf16 weights",
        "height": size, "width": size, "steps": steps, "executor_batch_size": SERVE_BATCH,
        "url": url, "tenants": [t.name for t in tenants],
        "alone": {"wire_s": wire_s, "submit_s": submit_s,
                  "wire_server_e2e_s": alone_inproc.e2e_s, "submit_server_e2e_s": ref.e2e_s,
                  "wire_overhead_s": wire_s - alone_inproc.e2e_s,
                  "final_event_bytes": len(json.dumps(alone_events[-1][1]))},
        "quota_rejection": {k: quota[k] for k in ("status", "error", "retryable")},
        "cancel": cancel, "status_poll": polled["status"],
        "requests": [{"tenant": tn, "queue_wait_s": r.queue_wait_s, "e2e_s": r.e2e_s,
                      "previews": r.previews, "first_preview_s": r.first_preview_s}
                     for (_, _, tn), r in zip(GATEWAY_REQUESTS, inproc)],
        "tenancy": snap["tenancy"], "gateway_counters": snap.get("gateway_requests"),
        "dispatches": dispatches, "finishes": finishes, "launches_while_serving": launches,
        "wire_equals_inprocess": wire_same, "wire_equals_submit": ref_same,
        "bit_identical_to_solo": solo,
    }
    print(json.dumps({"gateway": line}), flush=True)
    del logs
    gc.collect()
    torch.cuda.empty_cache()
    return line, [("unet", dispatches / 4), ("vae_mid", finishes)]


def fleet_phase(trees, steps=STEP_STEPS):
    """The replica fleet on the card (serve/replica.py, serve/fleet.py):
    ``build_fleet`` with two step-batching replicas on this card over the
    same trees (r0 weight 10, r1 weight 1, auto_restart on).  FLEET_REQUESTS
    go to r0; the "replica" fault site kills it at its FLEET_KILL_AFTER +
    1-th step round: its dying scheduler exports both carries, which resume
    on r1; FLEET_EXTRA arrive after the kill and run on r1 while the tick
    rebuilds r0 (a new server generation); then FLEET_AFTER_RESTART runs on
    r0; then ``_graphed_restart``.  Every image equals its solo call bit for
    bit.  Returns (the "fleet" line, the flash path's row weights)."""
    import torch

    from distrifuser_tpu_torch.serve import (REPLICA_SERVING, REPLICA_STOPPED, FaultPlan,
                                             FaultRule, FleetConfig, ResilienceConfig,
                                             build_fleet, pipeline_executor_factory)

    size = SIZES["sdxl"]
    make, logs = pipeline_executor_factory(_sdxl_build(trees)), {}

    def factory_for(name):
        def factory(key):
            logs.setdefault(name, []).append(_StepRounds(make(key)))
            return logs[name][-1]
        return factory

    plan = FaultPlan([FaultRule(site="replica", kind="kill", key_substr="r0", p=1.0,
                                max_fires=1, after_calls=FLEET_KILL_AFTER)], seed=0)
    config = _step_config(steps, resilience=ResilienceConfig(max_retries=0,
                                                             watchdog_timeout_s=600.0))
    fleet = build_fleet(factory_for, config,
                        FleetConfig(tick_s=0.05, auto_restart=True, restart_cooldown_s=0.2),
                        replicas=[("r0", 10.0), ("r1", 1.0)], model_id="sdxl",
                        scheduler="ddim", fault_plan=plan)
    t = time.perf_counter()
    fleet.start()
    start_s = time.perf_counter() - t
    r0, r1 = fleet.replica("r0"), fleet.replica("r1")
    first_warmup = {"r0": r0.last_warmup_s, "r1": r1.last_warmup_s}

    def submit(req):
        return fleet.submit(req[0], height=size, width=size, seed=req[1])

    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.monotonic()
        futs = [submit(r) for r in FLEET_REQUESTS]
        _wait(lambda: r0.state == REPLICA_STOPPED, "the kill")
        t_kill = next(t for t, _, to in r0.history if to == REPLICA_STOPPED)
        extra = [submit(r) for r in FLEET_EXTRA]
        migrated = [f.result(timeout=900) for f in futs]
        t_migrated = time.monotonic()
        extra_results = [f.result(timeout=900) for f in extra]
        _wait(lambda: r0.generation == 2 and r0.state == REPLICA_SERVING, "r0's restart")
        again = submit(FLEET_AFTER_RESTART).result(timeout=900)
        torch.cuda.synchronize()
        launches = read_counts()
        snap = fleet.metrics_snapshot()
        history = r0.history
    finally:
        fleet.stop()
    if plan.fired() != {"replica/kill": 1}:
        raise AssertionError(f"fleet: fired {plan.fired()}")
    if not all(r.replica == "r1" and r.migrations == 1
               and 1 <= r.steps_salvaged <= FLEET_KILL_AFTER for r in migrated):
        raise AssertionError(f"fleet: migrated {[(r.replica, r.migrations, r.steps_salvaged) for r in migrated]}")
    if not all(r.replica == "r1" for r in extra_results) or again.replica != "r0":
        raise AssertionError(f"fleet: routes {[r.replica for r in extra_results]}, "
                             f"{again.replica}")
    warm_start = next(t for t, frm, to in history if frm == REPLICA_STOPPED)
    warm_end = next(t for t, frm, to in history[::-1] if to == REPLICA_SERVING)
    during = sum(1 for log in logs["r1"] for r in log.rounds
                 if warm_start <= r["t0"] <= warm_end)
    requests = FLEET_REQUESTS + FLEET_EXTRA + [FLEET_AFTER_RESTART]
    outs = [r.output for r in migrated + extra_results + [again]]
    same = _solo_same(logs["r1"][0].ex.pipeline, requests, outs, steps)
    if not all(same):
        raise AssertionError(f"fleet: served images differ from their solo calls {same}")
    rounds = {name: [len(log.rounds) for log in logs[name]] for name in logs}
    all_logs = [log for name in logs for log in logs[name]]
    dispatches, flash = _step_flash(trees, all_logs, len(requests))
    if launches["flash_sdpa"] != flash:
        raise AssertionError(f"fleet: {launches} read, {dispatches} dispatches and "
                             f"{len(requests)} decodes make {flash}")
    del logs, all_logs
    gc.collect()
    torch.cuda.empty_cache()
    graphed, graphed_dispatches, graphed_flash = _graphed_restart(trees, FLEET_GRAPHED_STEPS)
    line = {
        "model": MODEL_NAMES["sdxl"] + ", random bf16 weights",
        "height": size, "width": size, "steps": steps, "executor_batch_size": SERVE_BATCH,
        "replicas": {"r0": 10.0, "r1": 1.0}, "start_s": start_s,
        "first_warmup_s": first_warmup, "kill_after_rounds": FLEET_KILL_AFTER,
        "kill_to_migrated_done_s": t_migrated - t_kill,
        "migrated": [{"replica": r.replica, "migrations": r.migrations,
                      "steps_salvaged": r.steps_salvaged, "queue_wait_s": r.queue_wait_s,
                      "execute_s": r.execute_s, "e2e_on_r1_s": r.e2e_s} for r in migrated],
        "failover_s": [(t_migrated - t_kill) - r.e2e_s for r in migrated],
        "restart": {"warm_s": r0.last_warmup_s, "generation": r0.generation,
                    "kill_to_warm_start_s": warm_start - t_kill,
                    "r1_rounds_during_r0_warmup": during},
        "r0_history": [(frm, to) for _, frm, to in history],
        "fleet_counters": snap["fleet"]["requests"],
        "rounds": rounds, "step_dispatches": dispatches,
        "step_launches_while_serving": launches, "bit_identical_to_solo": same,
        "graphed": graphed, "graphed_dispatches": graphed_dispatches,
        "dispatches": dispatches + graphed_dispatches,
        "launches_while_serving": {"flash_sdpa": launches["flash_sdpa"] + graphed_flash},
    }
    print(json.dumps({"fleet": line}), flush=True)
    return line, [("unet", dispatches / 4 + graphed_dispatches * FLEET_GRAPHED_STEPS / 4),
                  ("vae_mid", len(requests) + graphed_dispatches)]


def _graphed_restart(trees, steps):
    """The fleet phase's second part: two graphed whole-batch replicas over
    the same trees (executors at batch_size SERVE_BATCH, captured at
    warmup; their builds take turns on ``card_build_lock``).  r0 is
    drained and restarted on a thread -- a new generation, its build and
    capture -- while r1 replays its graphs for FLEET_GRAPHED; then r0
    serves FLEET_GRAPHED_AFTER.  Each dispatch 561 flash launches (r0's
    capture counts none of r1's launches, nor they its), every image equal
    to its solo call.  Returns (its part of the "fleet" line, dispatches,
    flash launches read)."""
    import threading

    import torch

    from distrifuser_tpu_torch.serve import (REPLICA_SERVING, FleetConfig, ResilienceConfig,
                                             ServeConfig, build_fleet,
                                             pipeline_executor_factory)

    from distrifuser_tpu_torch.models.unet import attention_calls_per_forward

    size = SIZES["sdxl"]
    make, calls, executors = pipeline_executor_factory(_sdxl_build(trees)), [], []
    started = []

    class Timed:
        """A replica's graphed executor, each call's host-clock span kept."""

        def __init__(self, ex, name):
            self.ex, self.name = ex, name
            self.batch_size, self.shallow_steps = ex.batch_size, ex.shallow_steps
            self.weight_nbytes = ex.weight_nbytes

        def __call__(self, *args):
            t0 = time.monotonic()
            started.append(self.name)
            out = self.ex(*args)
            calls.append({"replica": self.name, "t0": t0, "t1": time.monotonic()})
            return out

    def factory_for(name):
        def factory(key):
            executors.append(Timed(make(key), name))
            return executors[-1]
        return factory

    config = ServeConfig(
        buckets=((size, size),), max_batch_size=SERVE_BATCH, default_steps=steps,
        warmup_buckets=((size, size),), batch_window_s=0.05, default_ttl_s=600.0,
        resilience=ResilienceConfig(allow_batch_split=False, allow_stepwise_fallback=False,
                                    watchdog_timeout_s=600.0))
    fleet = build_fleet(factory_for, config, FleetConfig(tick_s=0),
                        replicas=[("r0", 10.0), ("r1", 1.0)], model_id="sdxl",
                        scheduler="ddim")
    t = time.perf_counter()
    fleet.start()
    start_s = time.perf_counter() - t
    r0 = fleet.replica("r0")
    try:
        torch.cuda.synchronize()
        reset_counts()
        fleet.drain_replica("r0")
        futs = [fleet.submit(p, height=size, width=size, seed=s) for p, s in FLEET_GRAPHED]
        _wait(lambda: bool(started), "r1's first dispatch")  # r1 replaying
        restart = threading.Thread(target=fleet.restart_replica, args=("r0",))
        restart.start()
        results = [f.result(timeout=900) for f in futs]
        restart.join(timeout=600)
        if restart.is_alive() or r0.state != REPLICA_SERVING or r0.generation != 2:
            raise AssertionError(f"fleet graphed: r0 {r0.state}, generation {r0.generation}")
        after = fleet.submit(FLEET_GRAPHED_AFTER[0], height=size, width=size,
                             seed=FLEET_GRAPHED_AFTER[1]).result(timeout=900)
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        fleet.stop()
    history = r0.history
    warm_start = [t for t, frm, to in history if (frm, to) == ("stopped", "warming")][-1]
    warm_end = [t for t, frm, to in history if (frm, to) == ("warming", "serving")][-1]
    during = [c for c in calls if c["replica"] == "r1"
              and c["t0"] < warm_end and c["t1"] > warm_start]
    if not all(r.replica == "r1" for r in results) or after.replica != "r0":
        raise AssertionError(f"fleet graphed: routes {[r.replica for r in results]}, "
                             f"{after.replica}")
    per_call = steps * attention_calls_per_forward(trees[0]) + 1
    if launches["flash_sdpa"] != per_call * len(calls):
        raise AssertionError(f"fleet graphed: {launches} read, {len(calls)} dispatches of "
                             f"{per_call}")
    pipe = executors[-1].ex.pipeline
    same = _solo_same(pipe, FLEET_GRAPHED + [FLEET_GRAPHED_AFTER],
                      [r.output for r in results + [after]], steps)
    if not all(same):
        raise AssertionError(f"fleet graphed: served images differ from their solo calls "
                             f"{same}")
    part = {"start_s": start_s, "restart_warm_s": r0.last_warmup_s,
            "restart_build_and_capture_s": r0.last_warmup_compile_s,
            "r1_dispatches_during_r0_restart": len(during),
            "dispatch_s": [c["t1"] - c["t0"] for c in calls],
            "launches_while_serving": launches, "bit_identical_to_solo": same}
    del executors, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return part, len(calls), launches["flash_sdpa"]


def autoscale_phase(trees, steps=STEP_STEPS):
    """The elastic pool on the card (serve/autoscale.py): ``build_fleet``
    with two step-batching slots, ``autoscale`` min 1, max 2, the router's
    tick driven by hand.  Only r0 warms at start; AUTO_BURST raise the
    pressure and the tick scales r1 up (it builds and warms while r0
    serves the burst); then two AUTO_LONG_STEPS-step stragglers, one on
    each replica, leave the pressure low and the tick drains r1 with
    ``release=True`` and AUTO_DRAIN_S: its straggler's carry exports and
    finishes on r0.  The stragglers' and the first burst request's images
    equal their solo calls bit for bit.  Returns (the "autoscale" line, the
    flash path's row weights)."""
    import torch

    from distrifuser_tpu_torch.serve import (REPLICA_SERVING, REPLICA_STARTING,
                                             REPLICA_STOPPED, AutoscaleConfig, FleetConfig,
                                             build_fleet, pipeline_executor_factory)

    size = SIZES["sdxl"]
    make, logs = pipeline_executor_factory(_sdxl_build(trees)), {}

    def factory_for(name):
        def factory(key):
            logs.setdefault(name, []).append(_StepRounds(make(key)))
            return logs[name][-1]
        return factory

    fc = FleetConfig(tick_s=0.0, autoscale=AutoscaleConfig(
        enabled=True, min_replicas=1, max_replicas=2, pressure_high=0.8, pressure_low=0.5,
        up_sustain_s=0.0, down_sustain_s=0.0, cooldown_s=0.0,
        drain_deadline_s=AUTO_DRAIN_S))
    router = build_fleet(factory_for, _step_config(steps), fc,
                         replicas=[("r0", 1.0), ("r1", 1.0)], model_id="sdxl",
                         scheduler="ddim")
    router.start()
    r0, r1 = router.replica("r0"), router.replica("r1")
    a = router.autoscaler
    if (r0.state, r1.state) != (REPLICA_SERVING, REPLICA_STARTING):
        raise AssertionError(f"autoscale: started {r0.state}, {r1.state}")
    try:
        torch.cuda.synchronize()
        reset_counts()
        burst = [router.submit(p, height=size, width=size, seed=s) for p, s in AUTO_BURST]
        pressure_up = a.pressure()
        t = time.monotonic()
        router.tick()
        _wait(lambda: r1.state == REPLICA_SERVING, "the scale-up")
        up_s = time.monotonic() - t
        warm_start = next(t for t, _, to in r1.history if to != REPLICA_SERVING)
        warm_end = next(t for t, _, to in r1.history if to == REPLICA_SERVING)
        r0_during = sum(1 for log in logs["r0"] for r in log.rounds
                        if warm_start <= r["t0"] <= warm_end)
        burst_results = [f.result(timeout=900) for f in burst]
        longs = [router.submit(p, height=size, width=size, seed=s,
                               num_inference_steps=AUTO_LONG_STEPS) for p, s in AUTO_LONG]
        _wait(lambda: all(len(rep.server.stepbatch.occupied()) == 1
                          and all(st.steps_done >= 2
                                  for st in rep.server.stepbatch.occupied())
                          for rep in (r0, r1)), "one straggler on each replica")
        pressure_down = a.pressure()
        t = time.monotonic()
        router.tick()
        _wait(lambda: r1.state == REPLICA_STOPPED, "the scale-down")
        down_s = time.monotonic() - t
        long_results = [f.result(timeout=900) for f in longs]
        torch.cuda.synchronize()
        launches = read_counts()
        counters = a.counters.snapshot()
        snap = router.metrics_snapshot()
    finally:
        router.stop()
    kept, moved = long_results
    if (counters.get("scale_ups"), counters.get("scale_downs")) != (1, 1):
        raise AssertionError(f"autoscale: counters {counters}")
    if (kept.replica, moved.replica, moved.migrations) != ("r0", "r0", 1) or \
            moved.steps_salvaged < 2:
        raise AssertionError(f"autoscale: stragglers {[(r.replica, r.migrations, r.steps_salvaged) for r in long_results]}")
    checked = [AUTO_BURST[0]] + AUTO_LONG
    same = (_solo_same(logs["r0"][0].ex.pipeline, checked[:1], [burst_results[0].output],
                       steps)
            + _solo_same(logs["r0"][0].ex.pipeline, checked[1:],
                         [kept.output, moved.output], AUTO_LONG_STEPS))
    if not all(same):
        raise AssertionError(f"autoscale: served images differ from their solo calls {same}")
    finishes = len(AUTO_BURST) + len(AUTO_LONG)
    all_logs = [log for name in logs for log in logs[name]]
    dispatches, flash = _step_flash(trees, all_logs, finishes)
    if launches["flash_sdpa"] != flash:
        raise AssertionError(f"autoscale: {launches} read, {dispatches} dispatches and "
                             f"{finishes} decodes make {flash}")
    line = {
        "model": MODEL_NAMES["sdxl"] + ", random bf16 weights",
        "height": size, "width": size, "steps": steps, "executor_batch_size": SERVE_BATCH,
        "config": {"min_replicas": 1, "max_replicas": 2, "pressure_high": 0.8,
                   "pressure_low": 0.5, "drain_deadline_s": AUTO_DRAIN_S},
        "pressure_at_burst": pressure_up, "pressure_with_stragglers": pressure_down,
        "scale_up_warm_s": r1.last_warmup_s, "scale_up_to_serving_s": up_s,
        "r0_rounds_during_r1_warmup": r0_during, "scale_down_to_stopped_s": down_s,
        "burst": [{"replica": r.replica, "e2e_s": r.e2e_s} for r in burst_results],
        "stragglers": [{"replica": r.replica, "migrations": r.migrations,
                        "steps_salvaged": r.steps_salvaged, "e2e_s": r.e2e_s}
                       for r in long_results],
        "counters": counters, "fleet_counters": snap["fleet"]["requests"],
        "dispatches": dispatches, "launches_while_serving": launches,
        "bit_identical_to_solo": same,
    }
    print(json.dumps({"autoscale": line}), flush=True)
    del logs, all_logs
    gc.collect()
    torch.cuda.empty_cache()
    return line, [("unet", dispatches / 4), ("vae_mid", finishes)]


def step_drive(pipe, model, steps, per_eval):
    """The step contract of the serve plane on one family's full-width
    pipeline (``pipe`` at batch_size 2, eager): two requests' solo step
    runs, then the same two joined mid-flight, packed when their next steps
    share a signature, one parked (carry to the host) while the other runs
    ahead, resumed and packed again at different step indices; each image
    equal to its solo run and the first to the monolithic call, bit for
    bit.  ``per_eval`` flash launches at the model's head dim a dispatch.
    Returns the "<model>_step" line."""
    import numpy as np

    from distrifuser_tpu_torch.parallel.rowpack import tree_leaves
    from distrifuser_tpu_torch.serve import ExecKey, PipelineExecutor

    size = SIZES[model]
    scheduler = {"pixart": "dpm-solver", "sd3": "flow-euler"}[model]
    key = ExecKey(model_id=model, scheduler=scheduler, height=size,
                  width=size, steps=steps, cfg=True, mesh_plan="dp1.cfg1.sp1",
                  exec_mode="step")
    log = _RoundLog(PipelineExecutor(pipe, steps, key=key))
    head_dim = {"pixart": 72, "sd3": 64}[model]
    a, b = (f"{PROMPT}, {model} step #0", 600), (f"{PROMPT}, {model} step #1", 601)

    def solo(prompt, seed):
        w = log.step_begin(prompt, "", seed, 5.0)
        for _ in range(steps):
            log.step_run([w])
        return np.asarray(log.step_finish(w))

    t0 = time.perf_counter()
    ref_a, ref_b = solo(*a), solo(*b)
    solo_rounds = len(log.rounds)
    mono = np.asarray(pipe(a[0], seed=a[1], num_inference_steps=steps, guidance_scale=5.0,
                           output_type="np").images[0])
    wa = log.step_begin(a[0], "", a[1], 5.0)
    log.step_run([wa])
    wb = log.step_begin(b[0], "", b[1], 5.0)  # joins mid-flight
    log.step_run([wa, wb])
    log.step_run([wa, wb])
    log.step_park(wa)
    parked_on_host = all(leaf.device.type == "cpu" for leaf in tree_leaves(wa["carry"]))
    log.step_run([wb])
    log.step_resume(wa)
    while not (log.step_done(wa) and log.step_done(wb)):
        log.step_run([w for w in (wa, wb) if not log.step_done(w)])
    got_a, got_b = np.asarray(log.step_finish(wa)), np.asarray(log.step_finish(wb))
    seconds = time.perf_counter() - t0
    checks = {"joined_parked_a_equals_solo": bool(np.array_equal(got_a, ref_a)),
              "joined_b_equals_solo": bool(np.array_equal(got_b, ref_b)),
              "solo_equals_monolithic": bool(np.array_equal(ref_a, mono)),
              "parked_carry_on_host": parked_on_host}
    if not all(checks.values()):
        raise AssertionError(f"{model} step drive: {checks}")
    rounds = log.rounds
    packed = [r for r in rounds if r["packed_rows"] == 2 and r["dispatches"] == 1]
    if not packed:
        raise AssertionError(f"{model} step drive: no packed dispatch {rounds}")
    for r in rounds:
        if r["launches"]["flash_sdpa"] != per_eval * r["dispatches"]:
            raise AssertionError(f"{model} step drive: a round launched {r['launches']}")
    dispatches = sum(r["dispatches"] for r in rounds)
    line = {"phase": f"{model}_step", "model": MODEL_NAMES[model] + ", random bf16 weights",
            "height": size, "width": size, "steps": steps, "executor_batch_size": 2,
            "head_dim": head_dim, "seconds": seconds, **checks,
            "solo_rounds": solo_rounds, "rounds_by_width": _rounds_by_width(rounds),
            "dispatches": dispatches, "packed_dispatches": len(packed),
            "flash_launches": sum(r["launches"]["flash_sdpa"] for r in rounds)}
    print(json.dumps(line), flush=True)
    return line



def cli_phase():
    """The command-line scripts in this process on the card, with random
    weights: ``run_sdxl --mode benchmark`` at 1024x1024 (1 untimed and 3
    timed 4-step calls to latents, 4 x 560 flash launches) must print its
    trimmed-mean latency line; ``sd_example`` img2img at SD 1.5's 512x512
    from an image written to a temporary directory (strength 0.5 of 4
    steps: 2 x 32 flash launches, the encoder's and the decoder's) must
    save its image.  Returns the lines."""
    import contextlib
    import io
    import shutil
    import tempfile

    from distrifuser_tpu_torch.cli import run_sdxl, sd_example
    from distrifuser_tpu_torch.models import unet

    lines = {}
    argv = ["--random_weights", "--image_size", "1024", "--mode", "benchmark",
            "--warmup_times", "1", "--test_times", "3", "--num_inference_steps", "4",
            "--output_type", "latent"]
    out = io.StringIO()
    per_call = 4 * unet.attention_calls_per_forward(unet.sdxl_config())
    with contextlib.redirect_stdout(out):
        rc, secs, launches = counted_call(lambda: run_sdxl.main(argv), "cli run_sdxl",
                                          4 * per_call)
    latency = [ln for ln in out.getvalue().splitlines() if ln.startswith("Latency: ")]
    line = {"phase": "cli", "run": "run_sdxl", "argv": " ".join(argv), "rc": rc,
            "printed": latency, "total_s": secs, "flash_sdpa_launches": launches["flash_sdpa"]}
    print(json.dumps(line), flush=True)
    if rc != 0 or len(latency) != 1 or float(latency[0].split()[1]) <= 0:
        raise AssertionError(f"run_sdxl benchmark: {line}")
    lines["run_sdxl"] = line

    tmp = tempfile.mkdtemp()
    try:
        from PIL import Image

        path, out_path = os.path.join(tmp, "init.png"), os.path.join(tmp, "out.png")
        Image.fromarray(init_image(SIZES["sd15"])).save(path)
        argv = ["--random_weights", "--init_image", path, "--strength", "0.5",
                "--num_inference_steps", "4", "--output_path", out_path]
        per_step = unet.attention_calls_per_forward(unet.sd15_config())
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, secs, launches = counted_call(lambda: sd_example.main(argv),
                                              "cli sd_example", 2 * per_step + 2)
        line = {"phase": "cli", "run": "sd_example img2img", "rc": rc, "total_s": secs,
                "flash_sdpa_launches": launches["flash_sdpa"],
                "saved_size": Image.open(out_path).size if os.path.exists(out_path) else None}
        print(json.dumps(line), flush=True)
        if rc != 0 or line["saved_size"] != (SIZES["sd15"], SIZES["sd15"]):
            raise AssertionError(f"sd_example img2img: {line}")
        lines["sd_example"] = line
    finally:
        shutil.rmtree(tmp)
    return lines


def expected_flash_launches(model, steps=4):
    """Flash launches of one ``steps``-step call of ``model``: the UNet's
    attentions at every step, the VAE's mid attention once."""
    from distrifuser_tpu_torch.models import unet

    return steps * unet.attention_calls_per_forward(model_configs(model)[0]) + 1


def sd_pipeline_phase(by_head_dim, expected_quant15):
    """The SD family's main path: SD 1.5 at 512x512 (DDIM) eagerly and under
    CUDA graphs, which must agree bit for bit, with the eager call's flash
    launches by head dim equal to ``by_head_dim``; one eager call each
    with Euler and DPM++ 2M; SD 1.5 with weight_quant int8 and fp8 under
    quant_compute="pallas", one call each under graphs captured by
    ``prepare`` (``expected_quant15`` launches of the quantized-matmul and
    quantization kernels a call); SD 2.1 at 768x768 (OpenCLIP ViT-H,
    v-prediction) under graphs, captured by ``prepare``, one call.  Returns
    the result lines by run."""
    expected = {"flash_sdpa": expected_flash_launches("sd15"), "quant_matmul": 0,
                "quantize_rows": 0}
    trees = build_trees("sd15")
    pipe, init_s = build_pipeline(trees, "sd15")
    eager, graphed, compare, _ = graphed_runs(pipe, init_s, "sd15", expected, model="sd15")
    for line in (eager, graphed, compare):
        print(json.dumps(line), flush=True)
    if not (compare["latent_bit_identical"] and compare["image_bit_identical"]):
        raise AssertionError(f"sd15: the graphed call differs from the eager one "
                             f"(latent rel L2 {compare['latent_rel_l2']})")
    if eager["flash_sdpa_launches_by_head_dim"] != by_head_dim:
        raise AssertionError(f"sd15: flash launches by head dim "
                             f"{eager['flash_sdpa_launches_by_head_dim']}, expected "
                             f"{by_head_dim}")
    results = {"sd15": graphed, "sd15_eager": eager}
    del pipe
    for scheduler in ("euler", "dpm-solver"):
        pipe, init_s = build_pipeline(trees, "sd15", scheduler=scheduler,
                                      use_cuda_graph=False)
        line, _ = pipeline_run(pipe, init_s, f"sd15 {scheduler}", expected, "sd15")
        print(json.dumps(line), flush=True)
        results[f"sd15_{scheduler}"] = line
        del pipe
    for mode in ("int8", "fp8"):
        pipe, init_s = build_pipeline(trees, "sd15", weight_quant=mode,
                                      quant_compute="pallas")
        t0 = time.perf_counter()
        pipe.prepare(4)
        capture_s = time.perf_counter() - t0
        line, _ = pipeline_run(pipe, init_s, f"sd15 {mode} graphed",
                               {**expected, "quant_matmul": expected_quant15,
                                "quantize_rows": expected_quant15}, "sd15")
        line["prepare_capture_s"] = capture_s
        print(json.dumps(line), flush=True)
        results[f"sd15_{mode}"] = line
        del pipe
    del trees
    trees = build_trees("sd21")
    pipe, init_s = build_pipeline(trees, "sd21")
    t0 = time.perf_counter()
    pipe.prepare(4)
    capture_s = time.perf_counter() - t0
    line, _ = pipeline_run(pipe, init_s, "sd21 graphed",
                           {**expected, "flash_sdpa": expected_flash_launches("sd21")},
                           "sd21")
    line["prepare_capture_s"] = capture_s
    print(json.dumps(line), flush=True)
    results["sd21"] = line
    del pipe, trees
    return results


def patch_transport(world):
    """How ``world`` ranks reach each other: one card a rank over NCCL
    (gloo for the CPU tensors of the tiny checks) where the machine has as
    many cards, else every rank on the one card in a gloo group, CUDA
    payloads staged through pinned host memory (parallel/collectives.py)."""
    import torch

    if torch.cuda.device_count() >= world:
        return {"backend": "cpu:gloo,cuda:nccl", "cards": world, "staging": None}
    return {"backend": "gloo", "cards": 1, "staging": "pinned host memory"}


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _refuses_graphs(model):
    """Is ``use_cuda_graph=True`` refused when a runner of ``model`` (the
    UNet's, the DiT's or the MMDiT's) is built on ranks that share the
    card?"""
    from distrifuser_tpu_torch import DistriConfig
    from distrifuser_tpu_torch.parallel.dit_sp import DiTDenoiseRunner
    from distrifuser_tpu_torch.parallel.mmdit_sp import MMDiTDenoiseRunner
    from distrifuser_tpu_torch.parallel.runner import DenoiseRunner
    from distrifuser_tpu_torch.schedulers import get_scheduler

    cfg = DistriConfig(height=SIZES[model], width=SIZES[model], warmup_steps=PATCH_WARMUP)
    runner = {"pixart": DiTDenoiseRunner, "sd3": MMDiTDenoiseRunner}.get(model,
                                                                         DenoiseRunner)
    try:
        runner(cfg, model_configs(model)[0], {},
               get_scheduler("flow-euler" if model == "sd3" else "ddim"))
    except ValueError as e:
        return "share a card" in str(e)
    return False


def _progress(rank, what, since):
    """A rank's progress through the multi-rank phase, on stderr as it
    happens (the result lines come only when every run is done)."""
    print(json.dumps({"progress": what, "rank": rank,
                      "s": round(time.perf_counter() - since, 1)}),
          file=sys.stderr, flush=True)


def _multi_rank(rank, world, backend, port, out_dir, profile, labels):
    """One rank of the multi-rank phase (a spawned process): for each run of
    ``labels`` (MULTI_RUNS), the tiny card-vs-CPU checks at this world, then
    the full-width pipeline: over NCCL eagerly and under CUDA graphs
    (``graphed_runs``); over gloo staging, where graphs are refused (checked
    first), eagerly: the patch run once untimed and once measured, the
    others once.  With ``profile`` each call mode of each run is profiled
    once more.  Writes its result lines and final latents to out_dir."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from distrifuser_tpu_torch.utils.env import set_precision_flags

    torch.cuda.set_device(rank % torch.cuda.device_count())
    # a collective that waits longer than this fails the phase, not the call
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        set_precision_flags()
        graphs = backend != "gloo"
        first = next((label for label in labels
                      if label in MULTI_RUNS and label not in PIPEFUSION_RUNS), "patch")
        if not graphs and not _refuses_graphs(MULTI_RUNS[first][3]):
            raise AssertionError(f"rank {rank}: use_cuda_graph=True was not refused "
                                 "with ranks sharing a card over gloo")
        out, trees = {}, {}
        t_spawn = time.perf_counter()
        for label in labels:
            # where a spawn cut at SPAWN_DEADLINE_S had got to
            _progress(rank, label, t_spawn)
            if label == "decode_sp":
                trees = {}  # the decode needs the VAE alone
                torch.cuda.empty_cache()
                out[label] = _decode_sp_runs(rank, world)
                continue
            if label in ("serve_ranks", "ranks_recover"):  # the patch runs' SDXL trees
                if "sdxl" not in trees:
                    trees = {"sdxl": build_trees("sdxl")}
                run = _serve_ranks_rank if label == "serve_ranks" else _ranks_recover_rank
                out[label] = run(rank, world, trees["sdxl"], graphs)
                continue
            if label in PIPEFUSION_RUNS:  # its own trees: one stage's blocks
                trees = {}
                torch.cuda.empty_cache()
                out[label] = _pipefusion_rank(label, rank, world, graphs)
                continue
            fields, tinies, want, model, steps = MULTI_RUNS[label]
            t0 = time.perf_counter()
            if model not in trees:  # one family's trees at a time
                trees = {model: build_trees(model, t5_layers=SPAWN_T5_LAYERS)}
            trees_s = time.perf_counter() - t0
            expected = multi_expected(label, trees[model][0])
            prompts = RUN_PROMPTS.get(label, [PROMPT])
            tiny = [tiny_check(steps=steps, use_cuda_graph=False,
                               **{"model": model, **fields, **t}) for t in tinies]
            pipe, init_s = build_pipeline(trees[model], model, use_cuda_graph=False,
                                          **fields)
            init_s += trees_s
            name = f"{label} rank {rank}"
            compare = None
            if graphs:
                eager, line, compare, latent = graphed_runs(pipe, init_s, name, expected,
                                                            steps=steps, model=model,
                                                            prompts=prompts)
                lines = [eager, line]
            else:
                warmup_s = None
                if label in ("patch", "sd15_patch", "dp") + KNOB_RUNS:
                    t0 = time.perf_counter()
                    pipe(prompts, num_inference_steps=steps, seed=0, output_type="np")
                    warmup_s = time.perf_counter() - t0
                line, latent = pipeline_run(pipe, init_s, name, expected, model, steps,
                                            prompts)
                line["warmup_call_s"] = warmup_s
                lines = [line]
            cfg = pipe.distri_config
            phases = pipe.runner.phase_counts
            if phases != want:
                raise AssertionError(f"{name}: steps by phase {phases}, expected {want}")
            plain, lse = decode_launches(fields, model)
            for line in lines:  # the decode's launches by d = 512 instance
                if line["flash_sdpa_d512_launches"] != {"plain": plain, "lse": lse}:
                    raise AssertionError(f"{name}: d = 512 launches "
                                         f"{line['flash_sdpa_d512_launches']}, expected "
                                         f"{plain} plain and {lse} log-sum-exp")
            free, total = torch.cuda.mem_get_info()
            for line in lines:
                line.update({
                    "phase": f"{label}_pipeline", "rank": rank, "world": world,
                    "parallelism": cfg.parallelism, "split_scheme": cfg.split_scheme,
                    "batch_idx": cfg.batch_idx(), "split_idx": cfg.split_idx(),
                    "dp_degree": cfg.dp_degree, "dp_idx": cfg.dp_idx(),
                    "vae_decode_parallel": pipe.vae_decode_parallel,
                    "n_device_per_batch": cfg.n_device_per_batch, "mode": cfg.mode,
                    "warmup_steps": cfg.warmup_steps, "steps_by_phase": phases,
                    "card_used_bytes_all_ranks": total - free,
                })
                if label in DIT_RUNS + SD3_RUNS:
                    line.update(transformer_line(pipe, line, steps, trees[model]))
                else:
                    line["comm_volume_elements"] = pipe.runner.comm_volume_report()
                if label in KNOB_RUNS or label == "patch":
                    line.update(knob_line(pipe, line, latent, label, out_dir, rank, steps))
            if profile:
                call = lambda cb: pipe(prompts, num_inference_steps=steps,  # noqa: E731
                                       seed=0, output_type="np", callback=cb)
                for line in lines:
                    pipe.set_stepwise(not line["use_cuda_graph"])
                    kind = "graphed" if line["use_cuda_graph"] else "eager"
                    line["profile"] = profile_call(call, os.path.join(
                        out_dir, f"profile_{label}_{kind}_rank{rank}.txt"),
                        phases=pipe.runner._phases(steps))
            np.save(os.path.join(out_dir, f"latent_{label}_rank{rank}.npy"), latent)
            if label == "patch":  # the plain path at compress_pcpp's step count
                six = MULTI_RUNS["compress_pcpp"][4]
                x6 = pipe(PROMPT, num_inference_steps=six, seed=0,
                          output_type="latent").images[0]
                np.save(os.path.join(out_dir, f"latent_patch{six}_rank{rank}.npy"),
                        np.asarray(x6, np.float32))
            out[label] = {"lines": lines, "tiny": tiny, "compare": compare}
            if label == "patch":
                out[label]["img2img"] = _multi_rank_img2img(pipe, name, model)
            del pipe
            torch.cuda.empty_cache()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        # the graphs hold NCCL work: free them before the process group
        gc.collect()
        torch.cuda.synchronize()
        dist.destroy_process_group()


def serve_ranks_expected(part, ucfg):
    """The launches one rank reads over a part of the serve_ranks run
    (``part``: its line on rank 0): a whole-batch or staged dispatch is a
    4-step call (``multi_expected``); a step dispatch one evaluation, an
    import at a later step one more (the template carry's step,
    serve/executors.py ``_carry_template``), a finishing decode the
    decode's (``decode_launches``); a dispatch at the tier
    ``knob_counts``."""
    from distrifuser_tpu_torch.models.unet import attention_calls_per_forward

    fields, _, _, model, steps = MULTI_RUNS["serve_ranks"]
    zero = {"quant_matmul": 0, "quantize_rows": 0, "dequantize_rows": 0, "all_to_all": 0}
    n = part["dispatches"]
    if part["part"] in ("whole", "staged"):
        call = multi_expected("serve_ranks", ucfg)
        return {**zero, "flash_sdpa": n * call["flash_sdpa"],
                "flash_sdpa_lse": n * call["flash_sdpa_lse"]}
    if part["part"] == "comm_compress":
        call = knob_counts({**fields, **serve_ranks_tier()}, steps, ucfg)
        return {**zero, **{k: n * call[k] for k in ("flash_sdpa", "flash_sdpa_lse",
                                                   "quantize_rows", "dequantize_rows")}}
    _, lse = decode_launches(fields, model)
    evals = n + part.get("template_steps", 0)
    return {**zero, "flash_sdpa": evals * attention_calls_per_forward(ucfg)
            + part["finishes"] * lse, "flash_sdpa_lse": part["finishes"] * lse}


def _serve_ranks_rank(rank, world, trees, graphs):
    """One rank of the "serve_ranks" run: serving over the spawn's ranks
    (serve/ranks.py ``serve_over_ranks``), SDXL 1024x1024 from ``trees`` at
    CFG 2 x sp 2, warmup 1, executors at batch_size SERVE_BATCH, graphed over
    NCCL and eager where the ranks share the card.  Five servers in turn,
    every rank's launch counts set to 0 just before each and read just
    after it: ``whole`` serves SERVE_RANKS_REQUESTS[:3] (batches of 2 and
    1), ``staged`` all four (pipeline_stages: two batches of 2), ``step``
    three step-batched (the third joining after two rounds) and then the
    fourth, which stops the server at step SERVE_RANKS_EXPORT_AT (a
    progress callback) so that its carry is exported from every rank,
    ``import`` resumes that carry on a second step server, and
    ``comm_compress`` serves the first at the SERVE_RANKS_TIER tier's knobs
    (``serve_ranks_tier``: the step cache and int8 refreshes, the refresh
    codec's kernels on every rank).  Then every rank runs each request's
    solo call of each key's pipeline, and rank 0 holds every served image
    to it, bit for bit.  Returns {"lines": one a part, rank 0's with the
    launches every rank must read (``serve_ranks_expected``), "tiny": []}."""
    import numpy as np
    import torch

    from distrifuser_tpu_torch.serve import (CarryExportedError, ResilienceConfig,
                                             ServeConfig, StepBatchConfig,
                                             pipeline_executor_factory, serve_over_ranks)

    size, reqs, steps = SIZES["sdxl"], SERVE_RANKS_REQUESTS, PATCH_STEPS
    fields = {"warmup_steps": PATCH_WARMUP, "use_cuda_graph": graphs}
    pipes = {}  # key.short() -> this rank's pipeline of the key

    def factory(tier_knobs):
        build = _sdxl_build(trees, tier_knobs=tier_knobs, **fields)

        def built(key):
            pipes[key.short()] = pipe = build(key)
            return pipe

        return pipeline_executor_factory(built)

    base = dict(buckets=((size, size),), max_batch_size=SERVE_BATCH, default_steps=steps,
                warmup_buckets=((size, size),), batch_window_s=SERVE_WINDOW_S,
                default_ttl_s=900.0, resilience=ResilienceConfig(watchdog_timeout_s=600.0))
    step_config = ServeConfig(**base, step_batching=StepBatchConfig(
        enabled=True, slots=SERVE_RANKS_SLOTS, preview_interval=1,
        step_service_prior_s=0.5))
    served = []  # rank 0: (key, request, image) of every served request
    t_run = time.perf_counter()
    snapshot = {}

    def part(name, config, drive, tier_knobs=False):
        _progress(rank, f"serve_ranks/{name}", t_run)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        server = serve_over_ranks(factory(tier_knobs), config, model_id="sdxl",
                                  scheduler="ddim", mesh_plan=f"dp1.cfg2.sp{world // 2}")
        line = {"phase": "serve_ranks", "part": name, "rank": rank, "world": world,
                "use_cuda_graph": graphs}
        if server is not None:
            server.start()
            try:
                line.update(drive(server))
                line["health_status"] = server.health()["status"]
            finally:
                server.stop()
        torch.cuda.synchronize()
        line["seconds"] = time.perf_counter() - t0
        line["launches"] = read_counts()
        return line

    def results(server, requests):
        return collect([server.submit(p, height=size, width=size, seed=s)
                        for p, s in requests], requests)

    def collect(futs, requests):
        rs = [f.result(timeout=900) for f in futs]
        served.extend((r.exec_key, q, r.output) for q, r in zip(requests, rs))
        return rs

    def record(rs):
        return {"dispatch_s": [r.execute_s for r in rs], "e2e_s": [r.e2e_s for r in rs],
                "batch_sizes": [r.batch_size for r in rs],
                "exec_keys": sorted({r.exec_key for r in rs})}

    def whole(server):
        rs = results(server, reqs[:3])
        return {**record(rs), "dispatches": server.metrics_snapshot()["requests"]["batches"]}

    def staged(server):
        rs = results(server, reqs)
        snap = server.metrics_snapshot()["staging"]
        return {**record(rs), "dispatches": snap["completed"],
                "peak_inflight": snap.get("peak_inflight")}

    def step(server):
        sb = server.stepbatch
        futs = [server.submit(p, height=size, width=size, seed=s) for p, s in reqs[:2]]
        _wait(lambda: sb.rounds >= 2, "serve_ranks: two step rounds")
        futs.append(server.submit(reqs[2][0], height=size, width=size, seed=reqs[2][1]))
        rs = collect(futs, reqs[:3])

        def stop_at(i, total, preview):
            if i == SERVE_RANKS_EXPORT_AT:
                server.request_stop()

        late = server.submit(reqs[3][0], height=size, width=size, seed=reqs[3][1],
                             on_progress=stop_at)
        try:
            late.result(timeout=900)
        except CarryExportedError as exc:
            snapshot.update(data=exc.snapshot, steps_done=exc.steps_done)
        if snapshot.get("data") is None:
            raise AssertionError("serve_ranks: the fourth request's carry was not exported")
        counters = server.metrics_snapshot()["requests"]
        return {**record(rs), "dispatches": counters.get("stepbatch_dispatches", 0),
                "finishes": len(rs), "packed_rows": counters.get("stepbatch_packed_rows", 0),
                "exported_at_step": snapshot["steps_done"],
                "snapshot_bytes": len(snapshot["data"])}

    def imported(server):
        r = server.submit(reqs[3][0], height=size, width=size, seed=reqs[3][1],
                          carry_snapshot=snapshot["data"]).result(timeout=900)
        served.append((r.exec_key, reqs[3], r.output))
        counters = server.metrics_snapshot()["requests"]
        return {**record([r]), "dispatches": counters.get("stepbatch_dispatches", 0),
                "finishes": 1, "steps_salvaged": r.steps_salvaged,
                "template_steps": 1 if r.steps_salvaged else 0}

    def comm(server):
        rs = results(server, reqs[:1])
        return {**record(rs), "dispatches": server.metrics_snapshot()["requests"]["batches"]}

    lines = [part("whole", ServeConfig(**base), whole),
             part("staged", ServeConfig(**base, pipeline_stages=True,
                                        max_inflight_batches=2), staged),
             part("step", step_config, step),
             part("import", ServeConfig(**dict(base, warmup_buckets=()),
                                        step_batching=step_config.step_batching), imported),
             part("comm_compress", ServeConfig(**base, **serve_ranks_tier()), comm,
                  tier_knobs=True)]
    # each key's solo calls, on every rank (each call is collective)
    solo = {key: [pipe(p, seed=s, num_inference_steps=steps, output_type="np").images[0]
                  for p, s in (reqs[:1] if ":sc" in key else reqs)]
            for key, pipe in sorted(pipes.items())}
    if rank == 0:
        for line in lines:
            line["expected"] = serve_ranks_expected(line, trees[0])
        same = [(key, q, bool(np.array_equal(solo[key][reqs.index(q)], np.asarray(img))))
                for key, q, img in served]
        if not all(ok for _, _, ok in same):
            raise AssertionError(f"serve_ranks: served images differ from the solo calls "
                                 f"{[(k, q[1], ok) for k, q, ok in same]}")
        lines[0]["bit_identical_to_solo"] = {
            key: sum(ok for k, _, ok in same if k == key) for key in sorted(solo)}
        lines[0]["image_sha256"] = {f"{key}:{q[1]}": image_digest(np.asarray(img))
                                    for key, q, img in served}
    del pipes, solo
    gc.collect()
    torch.cuda.empty_cache()
    return {"lines": lines, "tiny": []}


def _ranks_recover_rank(rank, world, trees, graphs):
    """One rank of the "ranks_recover" run (queue 3 fault 9): serving over
    the spawn's ranks (``serve_over_ranks``), SDXL 1024x1024 from ``trees``
    at CFG 2 x sp 2, warmup 1, executors at batch_size SERVE_BATCH, graphed
    over NCCL and eager where the ranks share the card, a watchdog bound of
    RECOVER_WATCHDOG_S.  Two parts, a server each, two requests each:

    * ``oom``: rank 1 alone holds SERVE_HELD_BYTES and asks for twice the
      card at the RECOVER_FAULT_STEP-th scheduler step of the first
      dispatch, a real ``torch.OutOfMemoryError`` between two steps'
      collectives while its peers run on into the next; every rank aborts
      its data groups, the ranks rebuild them and their executors, and the
      ladder's weight_quant_on rung builds the int8 key (quant_compute
      "pallas") on every rank, which serves both requests;
    * ``hang``: rank 1 alone sleeps RECOVER_HANG_S at that step; rank 0's
      watchdog (over NCCL) or its data groups' timeout (over gloo) ends the
      dispatch, the groups are aborted and rebuilt, the retry builds the
      dense key anew and serves both requests.

    Each part's line: rank 0's health (never "fatal"), the data groups'
    generation before and after, the aborts and rebuilds, the seconds from
    the abort to the first image, the rebuild's and the executors' build
    and capture seconds, and the launches of the second request's dispatch
    (counts set to 0 just before it).  After each part every rank runs each
    request's solo call at the rebuilt key (before the next part's fault
    retires its groups), and rank 0 holds each served image to it, bit for
    bit.  Returns {"lines": one a part, "tiny": []}."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from distrifuser_tpu_torch.serve import (ResilienceConfig, ServeConfig,
                                             pipeline_executor_factory, serve_over_ranks)
    from distrifuser_tpu_torch.utils.config import (data_group_generation,
                                                    rebuild_data_groups,
                                                    set_data_group_watchdog)

    # the data groups made so far take the run's timeout now, on every rank,
    # so that each part's generations count its fault's rebuild alone
    if set_data_group_watchdog(RECOVER_WATCHDOG_S):
        rebuild_data_groups()
    size, reqs, steps = SIZES["sdxl"], RECOVER_REQUESTS, PATCH_STEPS
    build = _sdxl_build(trees, warmup_steps=PATCH_WARMUP, use_cuda_graph=graphs)
    pipes = {}  # key.short() -> this rank's last pipeline of the key
    fault = {}  # the fault rank 1 injects into the next pipeline it builds
    held = []
    fired = []  # time.monotonic() of each fault rank 1 injected

    def inject(pipe, kind):
        """Rank 1's fault at its RECOVER_FAULT_STEP-th scheduler step."""
        sched, calls = pipe.runner.scheduler, [0]
        real = sched.step

        def step(*a, **kw):
            out = real(*a, **kw)
            calls[0] += 1
            if calls[0] == RECOVER_FAULT_STEP:
                fired.append(time.monotonic())
                if kind == "oom":
                    try:
                        held.append(torch.empty(SERVE_HELD_BYTES, dtype=torch.uint8,
                                                device="cuda"))
                        total = torch.cuda.get_device_properties(
                            torch.cuda.current_device()).total_memory
                        torch.empty(2 * total, dtype=torch.uint8, device="cuda")
                    finally:
                        fired.append(time.monotonic())  # raised
                time.sleep(RECOVER_HANG_S)
            return out

        sched.step = step

    def built(key):
        pipes[key.short()] = pipe = build(key)
        if rank == 1 and fault:
            inject(pipe, fault.pop("kind"))
        return pipe

    config = ServeConfig(
        buckets=((size, size),), max_batch_size=SERVE_BATCH, default_steps=steps,
        warmup_buckets=((size, size),), batch_window_s=SERVE_WINDOW_S, default_ttl_s=900.0,
        quant_compute="pallas",
        resilience=ResilienceConfig(allow_batch_split=False, allow_stepwise_fallback=False,
                                    allow_weight_quant_on=True, max_retries=2,
                                    backoff_base_s=0.01,
                                    watchdog_timeout_s=RECOVER_WATCHDOG_S))
    t_run = time.perf_counter()

    def part(kind):
        _progress(rank, f"ranks_recover/{kind}", t_run)
        fault["kind"] = kind
        torch.cuda.synchronize()
        before = data_group_generation()
        t0, m0 = time.perf_counter(), time.monotonic()
        fired.clear()
        server = serve_over_ranks(pipeline_executor_factory(built), config, model_id="sdxl",
                                  scheduler="ddim", mesh_plan=f"dp1.cfg2.sp{world // 2}")
        line = {"phase": "ranks_recover", "part": kind, "rank": rank, "world": world,
                "use_cuda_graph": graphs}
        served = []  # rank 0: (key, request, image)
        if server is not None:
            server.start()
            try:
                builds0 = server.cache.build_seconds
                p, s = reqs[0]
                first = server.submit(p, height=size, width=size, seed=s).result(timeout=900)
                t_first = time.monotonic()
                health = server.health()
                torch.cuda.synchronize()
                reset_counts()
                p, s = reqs[1]
                second = server.submit(p, height=size, width=size, seed=s).result(timeout=900)
                torch.cuda.synchronize()
                line["launches"] = read_counts()
                served.extend((r.exec_key, q, r.output)
                              for q, r in zip(reqs, (first, second)))
                ranks = health["ranks"]
                abort_t = server.ranks.last_abort_t
                line.update({
                    "status": health["status"], "status_after": server.health()["status"],
                    "aborts": ranks["aborts"], "rebuilds": ranks["rebuilds"],
                    "rebuild_s": ranks["rebuild_s"],
                    "build_and_capture_s": server.cache.build_seconds - builds0,
                    "abort_to_first_image_s": (t_first - abort_t) if abort_t else None,
                    "abort_at_s": (abort_t - m0) if abort_t else None,
                    "abort_reason": (server.ranks.last_abort_reason or "")[:300],
                    "errors": [e["message"][:200] for e in health["last_errors"]],
                    "exec_keys": [first.exec_key, second.exec_key],
                    "degradations": list(first.degradations),
                    "retries": [first.retries, second.retries],
                    "dispatch_s": [first.execute_s, second.execute_s],
                    "e2e_s": [first.e2e_s, second.e2e_s],
                    "watchdog_timeouts": health["requests"]["watchdog_timeouts"],
                    "last_error": (health["last_errors"][-1]["message"][:300]
                                   if health["last_errors"] else None)})
            finally:
                server.stop()
        held.clear()
        torch.cuda.synchronize()
        line["generations"] = [before, data_group_generation()]
        line["seconds"] = time.perf_counter() - t0
        if fired:  # rank 1: when its fault fired, and how long the OOM took to raise
            line["fault_at_s"] = fired[0] - m0
            if len(fired) > 1:
                line["oom_raised_after_s"] = fired[1] - fired[0]
        # each served key's solo calls at its rebuilt pipeline, on every
        # rank, before the next part's fault retires these groups
        box = [sorted({key for key, _, _ in served}) if rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        solo = {key: [pipes[key](p, seed=s, num_inference_steps=steps,
                                 output_type="np").images[0] for p, s in reqs]
                for key in box[0]}
        if rank == 0:
            line["bit_identical_to_solo"] = [
                bool(np.array_equal(solo[key][reqs.index(q)], np.asarray(img)))
                for key, q, img in served]
            if not all(line["bit_identical_to_solo"]):
                raise AssertionError(f"ranks_recover {kind}: served images differ from "
                                     f"the solo calls at the rebuilt keys "
                                     f"{line['bit_identical_to_solo']}")
        pipes.clear()
        gc.collect()
        torch.cuda.empty_cache()
        return line

    lines = [part("oom"), part("hang")]
    return {"lines": lines, "tiny": []}


def _decode_sp_runs(rank, world):
    """One rank of the sequence-parallel decode at ``world`` ranks
    (``pipelines.decode_latents``, which the pipelines call): the tiny VAE
    at sp ``world`` on the card (bf16) against the CPU (float32) at this
    world (relative L2 <= 8e-2); then a seeded 2048x2048 SDXL latent (1,
    256, 256, 4) through the SDXL VAE (seeded random bf16 weights) in each
    layout of DECODE_SP_LAYOUTS: one untimed call, then the measured one,
    with this rank's ms, its peak memory above what was allocated before
    the call, and the d = 512 launches by instance (n log-sum-exp, 0
    plain).  Rank 0 also decodes the latent whole, timed the same way, and
    in float32 (``fp32_reference_decode``): each layout's image may be no
    further from the float32 decode than the bf16 whole decode is, times
    DECODE_SP_NOISE_MARGIN (relative L2); its distance to the bf16 whole
    decode is reported beside it.  Returns the rank's result as the
    pipeline runs give it."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from distrifuser_tpu_torch import DistriConfig
    from distrifuser_tpu_torch.models import vae
    from distrifuser_tpu_torch.models.unet import cast_params
    from distrifuser_tpu_torch.ops import flash_attention as fa
    from distrifuser_tpu_torch.pipelines import decode_latents, decoder_choice

    tcfg = vae.tiny_vae_config()
    tparams = vae.init_vae_params(torch.Generator().manual_seed(0), tcfg)
    lat = torch.from_numpy(np.random.RandomState(0).randn(1, 16, 12, 4).astype(np.float32))
    outs = []
    for device, dtype in CHECK_DEVICES:
        dtype = getattr(torch, dtype)
        cfg = DistriConfig(device=device, height=8 * 16, width=8 * 12, split_batch=False,
                           use_cuda_graph=False)
        outs.append(decode_latents(cfg, tcfg, cast_params(tparams, dtype, device),
                                   lat.to(device, dtype)).float().cpu().numpy())
    ref, got = outs
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    tiny = {"phase": "decode_sp_tiny_check", "n": cfg.n_device_per_batch,
            "latent": [1, 16, 12, 4], "rel_l2": rel, "max_abs": float(np.abs(got - ref).max()),
            "limit_rel_l2": TINY_REL_L2["none"]}
    if not (np.isfinite(got).all() and rel <= TINY_REL_L2["none"]):
        raise AssertionError(f"decode_sp bf16/card vs fp32/cpu: {tiny}")

    vcfg = vae.sdxl_vae_config()
    params = vae.init_vae_params(torch.Generator(device="cuda").manual_seed(0), vcfg,
                                 torch.bfloat16)
    lh = DECODE_SIZE // 8
    latent = torch.randn(1, lh, lh, 4, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0)).bfloat16()

    def measured(decode, together=True):
        """(image, ms, peak bytes above the base, d = 512 launches) of a
        second call of ``decode``; ``together``: every rank starts it at
        once (a collective decode)."""
        decode()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        if together:
            dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        img = decode()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        lse = fa.flash_sdpa.lse_launches_by_head_dim[512]
        return (img.float().cpu().numpy(), ms, torch.cuda.max_memory_allocated() - base,
                {"plain": fa.flash_sdpa.launches_by_head_dim[512] - lse, "lse": lse})

    whole = ref = None
    if rank == 0:  # the others wait for it in their first collective
        ref = fp32_reference_decode(params, vcfg, latent)
        torch.cuda.empty_cache()
        whole = measured(lambda: vae.decode(params, vcfg, latent), together=False)
    lines = []
    for name, fields in DECODE_SP_LAYOUTS:
        cfg = DistriConfig(height=DECODE_SIZE, width=DECODE_SIZE, use_cuda_graph=False,
                           **fields)
        if decoder_choice(cfg) != (True, 0):
            raise AssertionError(f"decode_sp {name}: decoder {decoder_choice(cfg)}")
        n = cfg.n_device_per_batch
        img, ms, peak, d512 = measured(lambda: decode_latents(cfg, vcfg, params, latent))
        if d512 != {"plain": 0, "lse": n} or img.shape != (1, DECODE_SIZE, DECODE_SIZE, 3):
            raise AssertionError(f"decode_sp {name} rank {rank}: d = 512 launches {d512}, "
                                 f"image {img.shape}")
        line = {"phase": "decode_sp_2048", "run": name, "rank": rank, "world": world,
                "n": n, "batch_idx": cfg.batch_idx(), "split_idx": cfg.split_idx(),
                "latent": [1, lh, lh, 4], "ms": ms, "peak_allocated_above_base_bytes": peak,
                "flash_sdpa_d512_launches": d512, "finite": bool(np.isfinite(img).all()),
                "image_sha256": image_digest(img)}
        if whole is not None:
            rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
            line.update({"rel_l2_vs_whole": rel(img, whole[0]),
                         "rel_l2_vs_fp32_whole": rel(img, ref),
                         "whole_rel_l2_vs_fp32_whole": rel(whole[0], ref),
                         "limit_rel_l2_vs_fp32_whole": rel(whole[0], ref) * DECODE_SP_NOISE_MARGIN,
                         "whole_ms": whole[1], "whole_peak_allocated_above_base_bytes":
                         whole[2], "whole_d512_launches": whole[3]})
            if not (line["finite"] and line["rel_l2_vs_fp32_whole"]
                    <= line["limit_rel_l2_vs_fp32_whole"]):
                raise AssertionError(f"decode_sp {name}: {line}")
        lines.append(line)
        del img
        torch.cuda.empty_cache()
    return {"lines": lines, "tiny": [tiny], "compare": None}


def fp32_reference_decode(params, vcfg, latent):
    """The whole decode of ``latent`` in float32 on the card (TF32 off), its
    mid attention through the flash kernel's plain version in query chunks
    (the kernel has bf16 instances only): the reference that the bf16
    decodes are held to.  Returns the image as a float32 numpy array."""
    import torch

    from distrifuser_tpu_torch.models import vae
    from distrifuser_tpu_torch.models.unet import cast_params
    from distrifuser_tpu_torch.ops import flash_attention as fa

    def plain_sdpa(q, k, v, *, heads):
        rows = max(1, (1 << 28) // k.shape[1])
        return torch.cat([fa.flash_sdpa_reference(q[:, i:i + rows], k, v, heads=heads)
                          for i in range(0, q.shape[1], rows)], dim=1)

    kernel_sdpa, vae.sdpa = vae.sdpa, plain_sdpa
    try:
        return vae.decode(cast_params(params, torch.float32, "cuda"), vcfg,
                          latent.float()).cpu().numpy()
    finally:
        vae.sdpa = kernel_sdpa


def step_ms_by_phase(phases, line):
    """A pipeline line's measured step times grouped by the evaluation each
    step ran (``phases``: one a step; step_ms[i] ends step i + 1)."""
    step_ms = {}
    for phase, ms in zip(phases[1:], line["step_ms"]):
        step_ms.setdefault(phase, []).append(ms)
    return step_ms


def knob_line(pipe, line, latent, label, out_dir, rank, steps):
    """What a displaced-patch run adds to its pipeline line: the per-phase
    comm report and ``comm_plan`` (bytes a step of each phase exchanges, and
    the call's total), the measured step times grouped by the evaluation
    each step ran, the steps by phase, and the latent's relative L2 against
    the plain patch run of as many steps (information only)."""
    import numpy as np

    rep = pipe.runner.comm_volume_report(per_phase=True)
    plan = pipe.comm_plan(steps)
    phases = pipe.runner._phases(steps)
    extra = {"comm_bytes_per_step": rep["bytes"], "comm_elements_per_step": rep["phases"],
             "comm_plan": plan, "step_ms_by_phase": step_ms_by_phase(phases, line),
             "evaluations": phases}
    plain = os.path.join(out_dir, f"latent_patch{'' if steps == 4 else steps}_rank{rank}.npy")
    if label != "patch" and os.path.exists(plain):
        ref = np.load(plain).reshape(latent.shape)
        extra["latent_rel_l2_vs_plain_patch"] = float(
            np.linalg.norm(latent - ref) / np.linalg.norm(ref))
    return extra


def transformer_line(pipe, line, steps, trees):
    """What a PixArt or SD3 multi-rank run adds to its pipeline line: the
    DiT or MMDiT runner's ``comm_report`` (elements and bytes of one step),
    its ``attn_impl``, the measured step times by phase, ``comm_plan`` and
    the model's cut (the T5 at ``SPAWN_T5_LAYERS`` layers of full width, the
    transformer whole)."""
    phases = pipe.runner._phases(steps)
    return {"comm_report": pipe.runner.comm_report(1), "comm_plan": pipe.comm_plan(steps),
            "refresh_wire_bytes_by_phase": {ph: sum(wire.values()) for ph, wire
                                            in pipe.runner.refresh_wire.items()},
            "attn_impl": pipe.distri_config.attn_impl,
            "step_ms_by_phase": step_ms_by_phase(phases, line),
            "evaluations": phases, "t5_layers": trees[4][-1].num_layers,
            "transformer_depth": trees[0].depth}


def _multi_rank_img2img(pipe, name, model):
    """One img2img call of a multi-rank pipeline at strength 0.75 of 4
    steps: steps 1-3 run, 2 synchronous (counted from the first step that
    runs) and 1 stale at warmup 1 (3 x 140 flash launches, the encoder's,
    whole, and the decoder's: n log-sum-exp launches at sp n).  Returns
    its line."""
    import numpy as np

    from distrifuser_tpu_torch.models import unet

    per_step = unet.attention_calls_per_forward(model_configs(model)[0])
    image = init_image(SIZES[model])
    out, secs, launches = counted_call(
        lambda: pipe(PROMPT, image=image, strength=PATCH_I2I_STRENGTH,
                     num_inference_steps=PATCH_STEPS, seed=0, output_type="np").images[0],
        f"{name} img2img", 3 * per_step + 1 + sum(decode_launches(MULTI_RUNS["patch"][0],
                                                                  model)))
    phases = dict(pipe.runner.phase_counts)
    if phases != {"sync": 2, "stale": 1} or not np.isfinite(out).all():
        raise AssertionError(f"{name} img2img: steps by phase {phases}")
    return {"phase": "patch_img2img", "run": name, "strength": PATCH_I2I_STRENGTH,
            "steps": PATCH_STEPS, "steps_by_phase": phases, "total_s": secs,
            "use_cuda_graph": pipe.distri_config.use_cuda_graph,
            "flash_sdpa_launches": launches["flash_sdpa"], "image_sha256": image_digest(out)}


def _spawn(world, labels, backend, out_dir, profile):
    """Run ``labels`` on ``world`` spawned ranks; returns each rank's lines.
    Ranks that have not all exited within SPAWN_DEADLINE_S are killed and
    the phase fails."""
    import torch
    import torch.multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(out_dir):  # results of an earlier run
        if not os.path.isdir(os.path.join(out_dir, name)):
            os.remove(os.path.join(out_dir, name))
    torch.cuda.empty_cache()  # the ranks share the card with this process
    ctx = mp.spawn(_multi_rank, args=(world, backend, _free_port(), out_dir,
                                      profile, labels),
                   nprocs=world, join=False)
    deadline = time.perf_counter() + SPAWN_DEADLINE_S
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                done = [os.path.exists(os.path.join(out_dir, f"rank{r}.json"))
                        for r in range(world)]
                raise AssertionError(f"{labels} at world {world}: ranks still running "
                                     f"after {SPAWN_DEADLINE_S} s (results written: "
                                     f"{done})")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def patch_phase(dense_latent, out_dir, profile=False, runs=None):
    """Displaced patch (CFG 2 x sp 2, corrected_async_gn, warmup 1: 2
    synchronous and 2 stale steps), naive patch (CFG 2 x sp 2, alternate)
    and tensor parallelism (``tp_layout``) of SDXL, and SD 1.5's displaced
    patch at 512x512 (CFG 2 x sp 2, stale_gn, warmup 1), 4 steps, one
    process a rank (``patch_transport``): on every rank the tiny checks
    (bf16 on the card vs float32 on the CPU at the same world) and the
    full-width pipeline, whose image must be the same bit for bit on every
    rank; over NCCL also under CUDA graphs.  Prints the transport, each
    rank's lines, each rank's graphed-vs-eager comparison and the patch
    image against the single-card dense one (information only); returns
    rank 0's lines of each run (eager, then graphed over NCCL).
    ``profile`` adds each rank's profile of one more call.  ``runs`` (labels
    of MULTI_RUNS and "decode_sp") runs only those, in one spawn at
    PATCH_WORLD."""
    import numpy as np
    import torch

    cards = torch.cuda.device_count()
    tp_world, tp_n = tp_layout(cards)
    transport = patch_transport(PATCH_WORLD)
    spawns = [(PATCH_WORLD, ["patch", *KNOB_RUNS, "naive_patch"])]
    if tp_world == PATCH_WORLD:
        spawns[0][1].append("tensor")
    else:
        spawns.append((tp_world, ["tensor"]))
    spawns[0][1].extend(["sd15_patch", "dp", "serve_ranks"])
    later = [*DIT_RUNS, *SD3_RUNS, "decode_sp", *PIPEFUSION_RUNS]
    if transport["cards"] > 1:
        # over NCCL each run is eager and graphed: the transformer runs and
        # the decode take a spawn of their own (and its SPAWN_DEADLINE_S)
        spawns.append((PATCH_WORLD, later))
    else:
        spawns[0][1].extend(later)
    # fault 9's run first, in a spawn of its own: its aborted communicators
    # and abandoned threads end with its processes
    spawns.insert(0, (PATCH_WORLD, ["ranks_recover"]))
    if runs:
        spawns = [(PATCH_WORLD, list(runs))]
    print(json.dumps({"phase": "patch_transport", "world": PATCH_WORLD, **transport,
                      "tensor_parallel": {"world": tp_world, "n": tp_n}}), flush=True)
    results = {}
    for world, labels in spawns:
        # a folder a spawn: each clears its own at the start (the patch run's
        # latent stays in w<world> for the comparison below)
        sub = f"w{world}" if "patch" in labels else f"w{world}_{labels[0]}"
        ranks = _spawn(world, labels, transport["backend"], os.path.join(out_dir, sub),
                       profile)
        for label in labels:
            if label == "serve_ranks":
                results[label] = serve_ranks_report(ranks)
                continue
            if label == "ranks_recover":
                results[label] = ranks_recover_report(ranks)
                continue
            for r in ranks:
                if "refused" in r[label]:
                    print(json.dumps(r[label]["refused"]), flush=True)
            for line in ranks[0][label]["tiny"]:
                print(json.dumps({**line, "phase": f"{label}_tiny_check", "world": world}),
                      flush=True)
            for column in range(len(ranks[0][label]["lines"])):
                lines = [r[label]["lines"][column] for r in ranks]
                images = {line["image_sha256"] for line in lines}
                if len(images) != 1:
                    raise AssertionError(f"{label}: the ranks returned different images: "
                                         f"{sorted(images)}")
                for line in lines:
                    overlap = line.get("profile", {}).pop("overlap", None)
                    print(json.dumps(line), flush=True)
                    if overlap:
                        print(json.dumps({"phase": "overlap", "run": label,
                                          "rank": line["rank"],
                                          "use_cuda_graph": line["use_cuda_graph"],
                                          "stale_steps": overlap}), flush=True)
            if "img2img" in ranks[0][label]:
                lines = [r[label]["img2img"] for r in ranks]
                if len({line["image_sha256"] for line in lines}) != 1:
                    raise AssertionError(f"{label} img2img: the ranks returned different "
                                         "images")
                for line in lines:
                    print(json.dumps(line), flush=True)
                results[label + "_img2img"] = lines[0]
            for r in ranks:
                if r[label]["compare"] is not None:
                    compare = r[label]["compare"]
                    compare["within_limit"] = compare["latent_rel_l2"] <= GRAPH_REL_L2
                    print(json.dumps(compare), flush=True)
                    if not (compare["latent_bit_identical"] or compare["within_limit"]):
                        raise AssertionError(f"{compare['run']}: graphed latent rel L2 "
                                             f"{compare['latent_rel_l2']} over {GRAPH_REL_L2}")
            results[label] = ranks[0][label]["lines"]
    if "patch" not in results:
        return results
    latent = np.load(os.path.join(out_dir, f"w{PATCH_WORLD}", "latent_patch_rank0.npy"))
    info = {"phase": "patch_vs_dense", "same_image_on_all_ranks": True}
    if dense_latent is not None:
        info["latent_rel_l2_vs_single_card_dense"] = float(
            np.linalg.norm(latent - dense_latent) / np.linalg.norm(dense_latent))
    print(json.dumps(info), flush=True)
    return results


def serve_ranks_report(ranks):
    """Print the serve_ranks run's lines, each part's line of every rank,
    and raise unless every rank read the launches rank 0's closed form says
    (``serve_ranks_expected``) and the parts served as planned: batches of
    2 and 1 whole-batch, two staged dispatches, a request joining the step
    rounds, a carry exported and imported at step SERVE_RANKS_EXPORT_AT.
    Returns rank 0's lines."""
    lead = ranks[0]["serve_ranks"]["lines"]
    for i, line in enumerate(lead):
        for r in ranks:
            got = r["serve_ranks"]["lines"][i]
            if got["launches"] != line["expected"]:
                raise AssertionError(f"serve_ranks {line['part']} rank {got['rank']}: "
                                     f"launches {got['launches']}, expected "
                                     f"{line['expected']}")
            print(json.dumps(got), flush=True)
    parts = {line["part"]: line for line in lead}
    checks = {"whole batches (1, 2)": sorted(set(parts["whole"]["batch_sizes"])) == [1, 2]
              and parts["whole"]["dispatches"] == 2,
              "staged dispatches 2": parts["staged"]["dispatches"] == 2,
              "three step requests": len(parts["step"]["batch_sizes"]) == 3,
              "export at step": parts["step"]["exported_at_step"] == SERVE_RANKS_EXPORT_AT,
              "import at step": parts["import"]["steps_salvaged"] == SERVE_RANKS_EXPORT_AT,
              "codec launches": parts["comm_compress"]["launches"]["quantize_rows"] > 0}
    if not all(checks.values()):
        raise AssertionError(f"serve_ranks: {checks}")
    return lead


def ranks_recover_report(ranks):
    """Print the ranks_recover run's lines (each part's line of every rank)
    and raise unless, on rank 0, no part left the server "fatal", each
    aborted and rebuilt the data groups once on every rank (one generation
    more), the out-of-memory reached weight_quant_on and served at the int8
    key, and the second request's dispatch launched on rank 0 what a 4-step
    call of its key launches (``serve_ranks_expected``; the int8 key's
    quantized linears too).  Returns rank 0's lines."""
    from distrifuser_tpu_torch.models import unet

    ucfg = unet.sdxl_config()
    per_forward, per_call = unet.linear_calls(ucfg)
    lead = ranks[0]["ranks_recover"]["lines"]
    for i, line in enumerate(lead):
        want = serve_ranks_expected({"part": "whole", "dispatches": 1}, ucfg)
        if line["exec_keys"][1].endswith(":wq-int8:qc-pallas"):
            want.update(quant_matmul=PATCH_STEPS * per_forward + per_call,
                        quantize_rows=PATCH_STEPS * per_forward + per_call)
        line["expected"] = want
        if line["launches"] != want:
            raise AssertionError(f"ranks_recover {line['part']}: rank 0's launches "
                                 f"{line['launches']}, expected {want}")
        for r in ranks:
            got = r["ranks_recover"]["lines"][i]
            print(json.dumps(got), flush=True)
            if got["generations"][1] != got["generations"][0] + 1:
                raise AssertionError(f"ranks_recover {line['part']} rank {got['rank']}: "
                                     f"data group generations {got['generations']}")
    parts = {line["part"]: line for line in lead}
    checks = {part: line["status"] != "fatal" and line["status_after"] != "fatal"
              and line["aborts"] == 1 and line["rebuilds"] == 1
              and all(line["bit_identical_to_solo"]) for part, line in parts.items()}
    checks["oom to weight_quant_on"] = (parts["oom"]["degradations"] == ["weight_quant_on"]
                                        and parts["oom"]["exec_keys"][1].endswith(
                                            ":wq-int8:qc-pallas"))
    if not all(checks.values()):
        raise AssertionError(f"ranks_recover: {checks}")
    return lead


def _kernel_group(name: str) -> str:
    """Coarse family of a device kernel by its name (cuDNN convolution
    kernels are matched before GEMMs, which share the xmma/cutlass names)."""
    low = name.lower()
    if "nccl" in low:
        return COLLECTIVES
    if "flash_fwd_kernel" in low:
        return "attention (flash_sdpa)"
    if "qmm_kernel" in low:
        return "quantized matmul (quant_matmul)"
    if "dequantize_rows" in low:  # before its substring quantize_rows
        return "refresh decode (dequantize_rows)"
    if "quantize_rows" in low:  # the staged and the narrow kernels
        return "per-token quantization (quantize_rows)"
    if "conv" in low or "cudnn" in low or "implicit" in low:
        return "convolution"
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "gemm"
    if "norm" in low or "reduce" in low:
        return "reductions (norm moments, amax)"
    if "copy" in low or "cat" in low or "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise and other"


def _merge(intervals):
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(a, b, union):
    """How much of [a, b] lies under the disjoint sorted intervals ``union``."""
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in union if x < b and y > a)


def stale_step_overlap(events, marks, phases, details_path):
    """For each stale and shallow step of a profiled call (the device
    activities that start between its two step marks): each NCCL kernel's
    own device time
    and the share of its interval that lies under the rank's compute
    kernels (every other kernel; memory copies left out), and the exposed
    NCCL time, the time NCCL kernels run with no compute kernel beside
    them.  NCCL kernels spin while they wait for their peers, so their own
    time includes that wait.  The per-kernel list goes to
    ``details_path``; returns each step's sums and, by kernel name, the
    count, ms and covered share."""
    import torch

    kernels = [(e.time_range.start, e.time_range.end, e.name) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("nccl:")]
    steps, details = [], []
    for i in range(1, min(len(marks), len(phases))):
        if phases[i] not in ("stale", "shallow"):
            continue
        lo, hi = marks[i - 1], marks[i]
        step = [k for k in kernels if lo < k[0] <= hi]
        nccl = [k for k in step if "nccl" in k[2].lower()]
        compute = _merge([(a, b) for a, b, name in step if "nccl" not in name.lower()
                          and not name.startswith(("Memcpy", "Memset"))])
        by_name, own_us, covered_us = {}, 0.0, 0.0
        for a, b, name in nccl:
            cov = _covered(a, b, compute)
            details.append({"step": i, "name": name, "ms": (b - a) / 1e3,
                            "covered_share": cov / (b - a) if b > a else 1.0})
            agg = by_name.setdefault(name[:60], {"count": 0, "ms": 0.0, "covered_ms": 0.0})
            agg["count"] += 1
            agg["ms"] += (b - a) / 1e3
            agg["covered_ms"] += cov / 1e3
            own_us += b - a
            covered_us += cov
        exposed_us = sum(y - x - _covered(x, y, compute)
                         for x, y in _merge([(a, b) for a, b, _ in nccl]))
        steps.append({
            "step": i, "phase": phases[i], "step_ms": (hi - lo) / 1e3,
            "nccl_kernels": len(nccl),
            "nccl_ms": own_us / 1e3,
            "nccl_covered_share": covered_us / own_us if own_us else None,
            "exposed_nccl_ms": exposed_us / 1e3,
            "compute_ms": sum(y - x for x, y in compute) / 1e3,
            "by_kernel": {name: {"count": v["count"], "ms": v["ms"],
                                 "covered_share": v["covered_ms"] / v["ms"] if v["ms"] else None}
                          for name, v in by_name.items()}})
    with open(details_path, "w") as f:
        json.dump(details, f)
    return steps


def profile_call(fn, table_path, phases=None):
    """``fn()`` once under torch.profiler: the wall time, the device's busy
    time and idle share of it, device time by kernel family and the top
    kernels (the full table written to ``table_path``).  NCCL kernels run
    on their own stream beside the compute and spin while they wait for
    peers: they are reported as ``collective_ms`` and left out of the busy
    time, and the profiler's device-side ``nccl:*`` ranges, which repeat
    their kernels' time, are left out altogether.  With ``phases`` (the
    evaluation each step runs) ``fn`` takes a step callback, which
    synchronises the card and marks the step's end in the trace: the
    device activities (kernels, NCCL's included, and memory copies) that
    start between two marks are one step's, counted by the evaluation of
    that step (``launches_by_phase``, steps 1 on; step 0 shares its window
    with the text encoders), and each stale step's NCCL overlap
    (``stale_step_overlap``, ``overlap``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def on_step(i, t, x):
        torch.cuda.synchronize()
        with record_function("chip_smoke_step_end"):
            pass

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if phases is None:
            fn()
        else:
            fn(on_step)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("nccl:")]
    groups = {}
    for e in kernels:
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    collective_ms = groups.get(COLLECTIVES, 0.0)
    busy_ms = sum(groups.values()) - collective_ms
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    os.makedirs(os.path.dirname(table_path), exist_ok=True)
    with open(table_path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
    by_step = {}
    if phases is not None:
        events = prof.events()
        marks = sorted(e.time_range.start for e in events if e.name == "chip_smoke_step_end")
        starts = [e.time_range.start for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("nccl:")]
        for i in range(1, min(len(marks), len(phases))):
            n = sum(1 for t in starts if marks[i - 1] < t <= marks[i])
            by_step.setdefault(phases[i], []).append(n)
        overlap = stale_step_overlap(events, marks, phases, table_path + ".overlap.json")
    return {
        **({"launches_by_phase": by_step, "overlap": overlap} if phases is not None else {}),
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms, "collective_ms": collective_ms,
        "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                         "calls": e.count} for e in top],
    }


def profile_phase(out_dir, runs):
    """For each (model, weight_quant) of ``runs``: the main path once warm,
    eagerly and under CUDA graphs, each then once under torch.profiler
    (``profile_call``), printed side by side."""
    call = lambda pipe: pipe(PROMPT, num_inference_steps=4, seed=0,  # noqa: E731
                             output_type="np")
    trees = {}
    for model, weight_quant in runs:
        quant = {}
        if weight_quant != "none":
            quant = {"weight_quant": weight_quant, "quant_compute": "pallas"}
        if model not in trees:
            trees = {model: build_trees(model)}
        pipe, _ = build_pipeline(trees[model], model, **quant)
        line = {"phase": "profile", "model": model, "weight_quant": weight_quant}
        for kind in ("eager", "graphed"):
            pipe.set_stepwise(kind == "eager")
            call(pipe)
            line[kind] = profile_call(lambda: call(pipe), os.path.join(
                out_dir, f"profile_{model}_{weight_quant}_{kind}.txt"))
        print(json.dumps(line), flush=True)
        del pipe


def kernel_entry(rows, launches, prefix="", **fields):
    """One entry of the kernels line: per-shape numbers (the row keys that
    start with ``prefix``) weighted by each shape's launches in one
    pipeline call, and ``launches``, the count the main path read (left out
    where it is None: a form the path does not run)."""
    rows = [{k[len(prefix):]: v for k, v in r.items() if k.startswith(prefix)}
            | {"launches_per_call": r["launches_per_call"]}
            for r in rows if r["launches_per_call"]]
    ops_ms = sum(r["bound_ms"] * r["launches_per_call"] for r in rows
                 if r["bound_by"] == "operations")
    bytes_ms = sum(r["bound_ms"] * r["launches_per_call"] for r in rows
                   if r["bound_by"] == "bytes")

    def per_call(key):
        vals = [r.get(key) for r in rows]
        if any(v is None for v in vals):
            return None
        return sum(v * r["launches_per_call"] for v, r in zip(vals, rows))

    return {
        **fields,
        **({} if launches is None else {"launches": launches}),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_call("ms"),
        "device_ms": per_call("device_ms"),
        "plain_ms": per_call("plain_ms"),
        "bound_ms": ops_ms + bytes_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": per_call("library_ms"),
        "library_device_ms": per_call("library_device_ms"),
    }


def path_entry(rows, weights, launches, **fields):
    """``kernel_entry`` of another call of the path: each row whose shape
    name starts with a prefix of ``weights`` ((prefix, factor) pairs, the
    first match wins) counts its launches per call times the factor;
    raises unless those add up to ``launches``, the count that call read."""
    picked = []
    for r in rows:
        factor = next((f for prefix, f in weights if r["shape"].startswith(prefix)), 0)
        if factor:
            picked.append({**r, "launches_per_call": r["launches_per_call"] * factor})
    want = sum(r["launches_per_call"] for r in picked)
    if want != launches:
        raise AssertionError(f"{fields.get('work')}: {launches} launches read, the "
                             f"shapes account for {want}")
    return kernel_entry(picked, launches, **fields)


def serve_ranks_entries(rows, refresh_rows, multi_runs):
    """The serve_ranks run's launches on rank 0 as paths of the flash
    entry (its parts: the "@serve_ranks" rows, a dispatch at the tier's
    knobs with its shallow step like ``knob_entry``'s), of the d = 512
    entry (every decode of two images) and of the codec entries (the
    tier's refresh payloads): (flash, d512, quantize, dequantize)."""
    from distrifuser_tpu_torch.parallel.stepcache import phase_step_counts

    lines = {line["part"]: line for line in multi_runs["serve_ranks"]}
    frows = [r for r in rows if family(r["shape"]) == "serve_ranks"
             and r["shape"].startswith(("patch_unet", "vae_ring_1024_sp2"))]
    decode = "vae_ring_1024_sp2"
    work = ("rank 0 of the serve_ranks run's {part} part ({what}; SDXL 1024x1024 at "
            f"CFG 2 x sp 2, executors at batch_size {SERVE_BATCH})")
    whats = {"whole": "{n} whole-batch dispatches", "staged": "{n} staged dispatches",
             "step": "{n} step dispatches and {f} finishing decodes",
             "import": "{n} step dispatches after an imported carry, its template "
                       "step and {f} finishing decode",
             "comm_compress": f"{{n}} dispatch at the {SERVE_RANKS_TIER} tier"}
    flash, decodes = {}, 0
    for name, line in lines.items():
        n, f = line["dispatches"], line.get("finishes", 0)
        if name in ("whole", "staged"):
            weights, decodes = [("patch_unet", n), (decode, n)], decodes + n
        elif name == "comm_compress":
            knobs = serve_ranks_tier()
            counts = phase_step_counts(PATCH_STEPS, PATCH_WARMUP,
                                       knobs["step_cache_interval"])
            full = counts["sync"] + counts["stale"]
            weights = [("patch_unet_self_l1", n * (full + counts["shallow"]) / 4),
                       ("patch_unet_cross_l1", n * (full + counts["shallow"]) / 4),
                       ("patch_unet", n * full / 4), (decode, n)]
            decodes += n
        else:
            evals = n + line.get("template_steps", 0)
            weights, decodes = [("patch_unet", evals / 4), (decode, f)], decodes + f
        flash[f"serve_ranks_{name}"] = path_entry(
            frows, weights, line["launches"]["flash_sdpa"],
            work=work.format(part=name, what=whats[name].format(n=n, f=f)))
    d512 = path_entry(
        [r for r in frows if r["shape"].startswith(decode)], [(decode, decodes)],
        sum(line["launches"]["flash_sdpa_lse"] for line in lines.values()),
        work=f"rank 0's {decodes} sequence-parallel decodes of two images in the "
             "serve_ranks run")
    comm = lines["comm_compress"]
    picked = [r for r in refresh_rows if r["shape"].startswith("refresh_serve_ranks_")]
    codec = {prefix: kernel_entry(
        picked, comm["launches"][prefix + "rows"], prefix,
        work=f"the refresh payloads of rank 0's dispatch at the {SERVE_RANKS_TIER} "
             f"tier in the serve_ranks run ({serve_ranks_tier()}), bf16 sources; no "
             "library call")
        for prefix in ("quantize_", "dequantize_")}
    if sum(r["launches_per_call"] for r in picked) != comm["launches"]["quantize_rows"]:
        raise AssertionError("serve_ranks: the tier's payload rows account for "
                             f"{sum(r['launches_per_call'] for r in picked)} codec "
                             f"launches, {comm['launches']['quantize_rows']} read")
    return flash, d512, codec["quantize_"], codec["dequantize_"]


def ranks_recover_entries(rows, multi_runs):
    """The ranks_recover run's second dispatch of each part on rank 0 (a
    4-step 1024x1024 call at CFG 2 x sp 2 on the rebuilt groups: the int8
    key after the out-of-memory, the dense key after the hang) as paths of
    the flash entry, at the "@serve_ranks" rows."""
    frows = [r for r in rows if family(r["shape"]) == "serve_ranks"
             and r["shape"].startswith(("patch_unet", "vae_ring_1024_sp2"))]
    return {f"ranks_recover_{line['part']}": path_entry(
        frows, [("patch_unet", 1), ("vae_ring_1024_sp2", 1)],
        line["launches"]["flash_sdpa"],
        work=f"rank 0's dispatch of the ranks_recover run's {line['part']} part after the "
             f"rebuild of the data groups ({line['exec_keys'][1]}; SDXL 1024x1024 at CFG 2 "
             f"x sp 2, executors at batch_size {SERVE_BATCH})")
        for line in multi_runs["ranks_recover"]}


CONV_PROBE_SHAPES = ((4, 320, 320, 128), (4, 640, 640, 64), (4, 1280, 1280, 32),
                     (4, 640, 1280, 32), (4, 4, 320, 128), (2, 320, 320, 128),
                     (2, 640, 640, 64), (2, 1280, 1280, 32), (2, 512, 512, 128),
                     (2, 512, 512, 256), (2, 256, 256, 512), (2, 128, 128, 1024))


def conv_probe():
    """Why ops/conv.py convolves one image a launch on the card: for each
    3x3 conv shape (B, C_in, C_out, H) of SDXL's UNet (B = 4: two requests,
    CFG folded) and VAE (B = 2), a batch of one image repeated, whether
    cuDNN's batched call gives every row the same bits (with
    ``cudnn.deterministic`` off and on) and whether the per-image conv
    does, and both one's device ms under CUDA-graph replay; then whole
    graphed SDXL 1024x1024 calls (one and two prompts, 4 steps) with the
    UNet's and VAE's convs per image and batched, alternated (per image,
    batched, batched, per image), three timed calls each."""
    import torch
    import torch.nn.functional as F

    from distrifuser_tpu_torch import DistriConfig, DistriSDXLPipeline
    from distrifuser_tpu_torch.models import unet as unet_mod
    from distrifuser_tpu_torch.models import vae as vae_mod
    from distrifuser_tpu_torch.ops import conv as conv_mod
    from distrifuser_tpu_torch.parallel.compress import asdense

    per_image = conv_mod.conv2d

    def batched(p, x, *, stride=1, padding=None):
        kh, kw = p["kernel"].shape[2:]
        if padding is None:
            padding = ((kh - 1) // 2, (kw - 1) // 2)
        elif isinstance(padding, int):
            padding = (padding, padding)
        y = F.conv2d(x.permute(0, 3, 1, 2), asdense(p["kernel"]), p.get("bias"),
                     stride=stride, padding=padding)
        return y.permute(0, 2, 3, 1)

    def graphed_ms(fn, n=20, reps=5):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        best = None
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            graph.replay()
            b.record()
            torch.cuda.synchronize()
            best = min(best or 1e9, a.elapsed_time(b) / n)
        return best

    def rows_equal(y):
        return all(torch.equal(y[0], y[i]) for i in range(1, y.shape[0]))

    g = torch.Generator(device="cuda").manual_seed(0)
    for b, cin, cout, h in CONV_PROBE_SHAPES:
        x = torch.randn(1, h, h, cin, device="cuda", generator=g).bfloat16().expand(
            b, -1, -1, -1).contiguous()
        w = (torch.randn(cout, cin, 3, 3, device="cuda", generator=g) / (9 * cin) ** 0.5
             ).bfloat16().contiguous(memory_format=torch.channels_last)
        p = {"kernel": w, "bias": torch.zeros(cout, device="cuda").bfloat16()}
        line = {"phase": "conv_probe", "shape": [b, cin, cout, h],
                "per_image_rows_equal": rows_equal(per_image(p, x)),
                "batched_rows_equal": rows_equal(batched(p, x))}
        torch.backends.cudnn.deterministic = True
        line["batched_rows_equal_deterministic"] = rows_equal(batched(p, x))
        torch.backends.cudnn.deterministic = False
        line.update(per_image_ms=graphed_ms(lambda: per_image(p, x)),
                    batched_ms=graphed_ms(lambda: batched(p, x)))
        print(json.dumps(line), flush=True)
        if not line["per_image_rows_equal"]:
            raise AssertionError(f"conv_probe {line['shape']}: per-image rows differ")
    ucfg, unet_p, vcfg, vae_p, tcfgs, text_p = build_trees()
    try:
        for bs in (1, 2):
            for variant in ("per_image", "batched", "batched", "per_image"):
                unet_mod.conv2d = vae_mod.conv2d = (per_image if variant == "per_image"
                                                    else batched)
                cfg = DistriConfig(height=1024, width=1024, batch_size=bs)
                pipe = DistriSDXLPipeline.from_params(cfg, ucfg, unet_p, vcfg, vae_p, tcfgs,
                                                      text_p)
                pipe.prepare(4)
                prompts = [PROMPT] * bs
                pipe(prompts, num_inference_steps=4, output_type="np")
                times = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    pipe(prompts, num_inference_steps=4, output_type="np")
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t)
                print(json.dumps({"phase": "conv_probe_call", "prompts": bs, "conv": variant,
                                  "graphed_call_s": times}), flush=True)
                del pipe
                torch.cuda.empty_cache()
    finally:
        unet_mod.conv2d = vae_mod.conv2d = per_image


def build_kernels():
    """Build every kernel of the path, one nvcc per source, all started
    together; print each build's ptxas register and shared-memory report.
    Returns the spill store bytes of each flash instance by (head dim,
    log-sum-exp?) (empty where an earlier build was reused)."""
    from concurrent.futures import ThreadPoolExecutor

    from distrifuser_tpu_torch.ops import flash_attention as fa
    from distrifuser_tpu_torch.ops import quant_matmul as qm
    from distrifuser_tpu_torch.ops import quantize as qz

    def timed(build):
        t = time.perf_counter()
        return build(), time.perf_counter() - t

    sources = {"flash_attention.cu": fa.build, "quant_matmul.cu": qm.build,
               "quantize_rows.cu": qz.build, "dequantize_rows.cu": qz.build_decode}
    with ThreadPoolExecutor(len(sources)) as pool:
        done = dict(zip(sources, pool.map(timed, sources.values())))
    spills = {}
    for name, (log, seconds) in done.items():
        print(f"built {name} in {seconds:.1f} s", flush=True)
        head_dim = None
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill")) or \
                    "error" in line.lower():
                print(f"  ptxas: {line.strip()}", flush=True)
            # a flash instance's entry (Config<D, ...>, LSE), then its spill line
            entry = re.search(r"flash_fwd_kernel.*?ConfigILi(\d+)E.*?Lb([01])E", line)
            if entry:
                head_dim = (int(entry.group(1)), entry.group(2) == "1")
            spill = re.search(r"(\d+) bytes spill stores", line)
            if spill and head_dim is not None:
                spills[head_dim] = int(spill.group(1))
                head_dim = None
    return spills


def main(argv) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="only profile the warm main path (torch.profiler), "
                             "eagerly and under CUDA graphs (SDXL, SD 1.5 and PixArt-α "
                             "dense), "
                             "and print the device-time breakdowns; with "
                             "--patch_only, profile each rank's calls")
    parser.add_argument("--weight_quant", default=None, choices=("none", "int8", "fp8"),
                        help="with --profile: only this SDXL path (default: "
                             "dense, int8 and fp8; quantized runs use "
                             "quant_compute='pallas'), beside SD 1.5 dense")
    parser.add_argument("--out_dir", default="build/profile",
                        help="where --profile writes its full kernel tables and "
                             "the multi-rank phase its ranks' results")
    parser.add_argument("--patch_only", action="store_true",
                        help="only the multi-rank runs (patch, the comm-knob runs, "
                             "naive patch, tensor parallelism): their flash and "
                             "refresh-quantization shapes and the multi-rank phase")
    parser.add_argument("--runs", default=None,
                        help="with --patch_only: only these multi-rank runs, comma-"
                             "separated (MULTI_RUNS labels, decode_sp), in one spawn, "
                             "without the kernel rows and the kernels line")
    parser.add_argument("--serve_only", action="store_true",
                        help="only the serve phases: their flash and quant kernel "
                             "rows (\"@serve\") and the SDXL serve plane on the card "
                             "(whole-batch, staged, step batching, the SLO controller, "
                             "the gateway, the fleet and autoscale)")
    parser.add_argument("--conv_probe", action="store_true",
                        help="only the probe of cuDNN's batch-position dependence at "
                             "SDXL's conv shapes and the per-image conv's cost "
                             "(``conv_probe``)")
    parser.add_argument("--quant_device_times", action="store_true",
                        help="only time the quantized-matmul kernel's contract form "
                             "and the per-token quantization on the card at every "
                             "path shape (device time)")
    parser.add_argument("--encoder_source", default=None,
                        help="with --quant_device_times: build the per-token "
                             "quantization from this variant of "
                             "csrc/quantize_rows.cu instead")
    args = parser.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 2
    try:
        from distrifuser_tpu_torch.models import unet, vae
        from distrifuser_tpu_torch.utils.env import set_precision_flags
    except ImportError as e:
        print(f"chip_smoke: the distrifuser_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    ucfg, vcfg = unet.sdxl_config(), vae.sdxl_vae_config()
    steps = 4
    if args.quant_device_times:
        from distrifuser_tpu_torch.ops import quant_matmul as qm

        qm.build()
        set_precision_flags()
        ucfg15 = model_configs("sd15")[0]
        quant_device_phase(quant_shapes(ucfg, 1024, 1024, steps)
                           + quant_shapes(ucfg15, SIZES["sd15"], SIZES["sd15"], steps,
                                          suffix=SD15), args.encoder_source)
        return 0
    spills = build_kernels()
    if args.conv_probe:
        set_precision_flags()
        conv_probe()
        return finish(None)

    set_precision_flags()
    if args.profile and not args.patch_only:
        quants = [args.weight_quant] if args.weight_quant else ["none", "int8", "fp8"]
        profile_phase(args.out_dir, [("sdxl", q) for q in quants]
                      + [("sd15", "none"), ("pixart", "none"), ("sd3", "none")])
        return 0
    shapes = attention_shapes(ucfg, vcfg, 1024, 1024, unet_evals=steps)
    expected_flash = steps * unet.attention_calls_per_forward(ucfg) + 1
    assert sum(s[-1] for s in shapes) == expected_flash, (shapes, expected_flash)
    per_forward, per_call = unet.linear_calls(ucfg)
    expected_quant = steps * per_forward + per_call
    qshapes = quant_shapes(ucfg, 1024, 1024, steps)
    assert sum(s[-1] for s in qshapes) == expected_quant, (qshapes, expected_quant)
    # the serve phase: the same calls at batch_size SERVE_BATCH ("@serve" rows)
    serve_shapes = attention_shapes(ucfg, vcfg, 1024, 1024, unet_evals=steps, suffix=SERVE,
                                    batch=SERVE_BATCH)
    assert sum(s[-1] for s in serve_shapes) == expected_flash, serve_shapes
    serve_qshapes = quant_shapes(ucfg, 1024, 1024, steps, batch=2 * SERVE_BATCH, suffix=SERVE)
    assert sum(s[-1] for s in serve_qshapes) == expected_quant, serve_qshapes

    def serve_kernels(rows, qrows, line):
        """The serve phase's launches as paths of the kernels line's
        entries: the dense server's dispatches (flash) and the int8 key's
        after the OOM (flash, quant_matmul, quantize_rows), each a count of
        dispatches times the "@serve" rows' launches a call."""
        frows = rows_of(rows, ("unet", "vae_mid"), "serve")
        int8_rows = [r for r in qrows if r["mode"] == "int8" and family(r["shape"]) == "serve"]
        dense, oom = line["dense"], line["oom"]
        work = ("{n} dispatches of the serve phase's {what} (InferenceServer, executors at "
                f"batch_size {SERVE_BATCH}, 4-step 1024x1024 SDXL calls)")
        flash = {"serve": path_entry(
            frows, [("unet", dense["dispatches"]), ("vae_mid", dense["dispatches"])],
            dense["launches"]["flash_sdpa"],
            work=work.format(n=dense["dispatches"], what="dense server")),
            "serve_int8": path_entry(
            frows, [("unet", oom["dispatches"]), ("vae_mid", oom["dispatches"])],
            oom["launches"]["flash_sdpa"],
            work=work.format(n=oom["dispatches"], what="int8 key after the OOM"))}
        quant = {name: path_entry(int8_rows, [("", oom["dispatches"])],
                                  oom["launches"][name], prefix=prefix,
                                  work=work.format(n=oom["dispatches"],
                                                   what="int8 key after the OOM"))
                 for name, prefix in (("quant_matmul", "fused_"),
                                      ("quantize_rows", "quantize_"))}
        # the fused int8 form has no library call; the torch._int_mm product
        # alone (the contract rows' library) at the same shapes, a dispatch
        product = kernel_entry(int8_rows, None)
        quant["quant_matmul"]["int_mm_product_ms_per_dispatch"] = product["library_ms"]
        quant["quant_matmul"]["int_mm_product_device_ms_per_dispatch"] = (
            product["library_device_ms"])
        return flash, quant
    def step_serve_kernels(rows, qrows, staged, step):
        """The staged and step phases' launches as paths of the flash
        entry (both at the "@serve" rows: executors at batch_size
        SERVE_BATCH) and the step phase's int8 key as paths of the quant
        entries: a step dispatch is one UNet evaluation (a fourth of a
        4-step call's rows) plus, for the int8 key, the text KV the step
        recomputes."""
        frows = rows_of(rows, ("unet", "vae_mid"), "serve")
        n = step["dispatches"]
        flash = {
            "serve_staged": path_entry(
                frows, [("unet", staged["dispatches"]), ("vae_mid", staged["dispatches"])],
                staged["launches"]["flash_sdpa"],
                work=f"{staged['dispatches']} dispatches of the staged phase "
                     "(pipeline_stages, executors at batch_size "
                     f"{SERVE_BATCH}, 4-step 1024x1024 SDXL calls, graphed)"),
            "serve_step": path_entry(
                frows, [("unet", n / 4), ("vae_mid", step["finishes"])],
                step["launches_while_serving"]["flash_sdpa"],
                work=f"the step phase's {n} dispatches (eager SDXL evaluations at "
                     f"B = {2 * SERVE_BATCH}, solo or packed) and {step['finishes']} "
                     "finishing decodes")}
        int8_rows = [r for r in qrows if r["mode"] == "int8" and family(r["shape"]) == "serve"]
        m = step["int8"]["dispatches"]
        weights = [(f"l{lvl}_text_kv", m) for lvl in range(4)] + [("", m / 4)]
        work = (f"the step phase's int8 key: {m} dispatches (each an evaluation's "
                "linears and the text KV it recomputes)")
        quant = {name: path_entry(int8_rows, weights, step["int8"][name + "_launches"],
                                  prefix=prefix, work=work)
                 for name, prefix in (("quant_matmul", "fused_"),
                                      ("quantize_rows", "quantize_"))}
        return flash, quant
    def plane_kernels(rows, paths):
        """The controller, gateway, fleet and autoscale phases' launches as
        paths of the flash entry ("@serve" rows: executors at batch_size
        SERVE_BATCH): ``paths`` maps each path to its phase line and row
        weights."""
        frows = rows_of(rows, ("unet", "vae_mid"), "serve")
        works = {"serve_controller": "the controller phase's {n} whole-batch dispatches, "
                                     "graphed, each at its tier's steps and shallow steps",
                 "serve_gateway": "the gateway phase's {n} step dispatches (eager SDXL "
                                  "evaluations at B = 4) and its finishing decodes",
                 "serve_fleet": "the fleet phase's {n} step dispatches on both replicas "
                                "and its finishing decodes",
                 "serve_autoscale": "the autoscale phase's {n} step dispatches on both "
                                    "replicas and its finishing decodes"}
        return {name: path_entry(frows, list(weights.items()) if isinstance(weights, dict)
                                 else weights, line["launches_while_serving"]["flash_sdpa"],
                                 work=works[name].format(n=line["dispatches"]))
                for name, (line, weights) in paths.items()}

    def plane_phases(trees):
        """Phases 5i-5l on ``trees``: {path: (line, row weights)} and their
        seconds."""
        out, secs = {}, {}
        for name, fn in (("serve_controller", lambda: controller_phase(trees, steps)),
                         ("serve_gateway", lambda: gateway_phase(trees)),
                         ("serve_fleet", lambda: fleet_phase(trees)),
                         ("serve_autoscale", lambda: autoscale_phase(trees))):
            t = time.perf_counter()
            out[name] = fn()
            secs[name] = time.perf_counter() - t
        return out, secs

    # one prompt under the CFG split: one row a rank, n = world / 2 patches
    pshapes = patch_attention_shapes(shapes, n=PATCH_WORLD // 2, batch=1)
    nshapes = naive_attention_shapes(shapes, n=PATCH_WORLD // 2, batch=1)
    tp_n = tp_layout(torch.cuda.device_count())[1]
    tshapes = tp_attention_shapes(shapes, n=tp_n, batch=2)
    multi = [s for s in pshapes + nshapes + tshapes if not s[0].startswith(("unet", "vae"))]
    # the dp run: each image group sp 2 with the CFG folded (B = 2, one image)
    dp_n = PATCH_WORLD // MULTI_RUNS["dp"][0]["dp_degree"]
    multi += [("dp_" + s[0][len("patch_"):], *s[1:])
              for s in patch_attention_shapes(shapes, n=dp_n, batch=2)
              if s[0].startswith("patch_")]
    # SD 1.5 at 512x512 ("@sd15" rows): its dense call and one patch rank
    ucfg15, vcfg15, _ = model_configs("sd15")
    size15 = SIZES["sd15"]
    shapes15 = attention_shapes(ucfg15, vcfg15, size15, size15, steps, suffix=SD15)
    assert sum(s[-1] for s in shapes15) == expected_flash_launches("sd15"), shapes15
    by_head_dim15 = {}
    for s in shapes15:
        by_head_dim15[s[5]] = by_head_dim15.get(s[5], 0) + s[6]
    multi += [s for s in patch_attention_shapes(shapes15, n=PATCH_WORLD // 2, batch=1)
              if s[0].startswith("patch_")]
    # the serve_ranks run: a rank of the patch path at CFG 2 x sp 2 holding
    # the 2 rows of one branch ("@serve_ranks" rows; its decode's at B = 2 are
    # in VAE_RING_HOPS)
    multi += [(s[0] + SERVE_RANKS, *s[1:])
              for s in patch_attention_shapes(shapes, n=PATCH_WORLD // 2, batch=SERVE_BATCH)
              if s[0].startswith("patch_")]
    # img2img's VAE encoder: its mid attention at the decoder's shape, once
    # a call; the whole-latent decode of a 2048x2048 latent, once
    enc_rows = [("i2i_vae_encoder_mid" + row[0][len("vae_mid"):], *row[1:])
                for row in shapes + shapes15 if row[0].startswith("vae_mid")]
    decode_rows = [("decode2048_vae_mid_whole", 1, (DECODE_SIZE // 8) ** 2,
                    (DECODE_SIZE // 8) ** 2, 1, vcfg.block_out_channels[-1], 1)]
    vae_rows = [s for s in shapes + shapes15 if s[0].startswith("vae_mid")] + enc_rows
    # SD 2.1 at 768x768 ("@sd21" rows): its dense call
    ucfg21, vcfg21, _ = model_configs("sd21")
    size21 = SIZES["sd21"]
    shapes21 = attention_shapes(ucfg21, vcfg21, size21, size21, steps, suffix=SD21)
    assert sum(s[-1] for s in shapes21) == expected_flash_launches("sd21"), shapes21
    # SD3 ("@sd3" rows): its dense call, one "sd3" rank, SD3.5-medium's dual
    # attention; the "sd3_ring" rank's log-sum-exp chunks
    shapes3, hops3 = sd3_attention_shapes(steps)

    def rows_of(rows, prefixes, fam):
        return [r for r in rows if r["shape"].startswith(prefixes)
                and family(r["shape"]) == fam]

    def multi_entries(rows, multi_runs):
        works = {"patch": "one rank of the patch path at CFG 2 x sp 2",
                 "patch_img2img": "one rank of the patch path's img2img call at CFG 2 x "
                                  "sp 2 (strength 0.75 of 4 steps: steps 1-3)",
                 "naive_patch": "one rank of naive patch parallelism at CFG 2 x sp 2 "
                                "(alternate)",
                 "tensor": f"one rank of tensor parallelism at tp {tp_n}",
                 "sd15_patch": "one rank of SD 1.5's patch path at CFG 2 x sp 2 "
                               "(stale_gn)",
                 "dp": "one rank of the dp run (2 image groups of sp 2, CFG folded), "
                       "two prompts"}
        prefixes = {"patch": "patch_", "naive_patch": "naive_", "tensor": f"tp{tp_n}_",
                    "sd15_patch": "patch_", "dp": "dp_"}
        out = {}
        for label, lines in multi_runs.items():
            # the d = 512 and 72 entries', the SD3 runs' (``sd3_entries``) and
            # the serve plane's over the ranks (``serve_ranks_entries``)
            if label in ("decode_sp", "serve_ranks", "ranks_recover") or label in (
                    DIT_RUNS + SD3_RUNS + PIPEFUSION_RUNS):
                continue
            if label in KNOB_RUNS:
                out[label] = knob_entry(rows, label, lines)
                continue
            if label == "patch_img2img":
                out[label] = path_entry(
                    rows_of(rows, ("patch_unet", "i2i_vae_encoder_mid", "vae_ring_1024"),
                            "sdxl"),
                    [("patch_unet", 0.75), ("i2i_vae_encoder_mid", 1),
                     ("vae_ring_1024_sp2", 1)],
                    lines["flash_sdpa_launches"], work=works[label])
                continue
            fam = MULTI_RUNS[label][3]
            size = SIZES[fam]
            out[label] = kernel_entry(
                rows_of(rows, prefixes[label], fam) + decode_rows_of(rows, label),
                lines[-1]["flash_sdpa_launches"],
                work=works[label] + f", 4-step {size}x{size} call")
        return out

    def decode_rows_of(rows, label):
        """The row of the decode of a multi-rank run: the decode ring's at
        sp n (``decode_launches``), else the whole decode's mid attention."""
        fields, _, _, model, _ = MULTI_RUNS[label]
        lse = decode_launches(fields, model)[1]
        return rows_of(rows, f"vae_ring_{SIZES[model]}_sp{lse}" if lse else "vae_mid", model)

    def d512_entry(rows, multi_runs):
        """The d = 512 log-sum-exp instance: the sequence-parallel decode's
        ring in one rank's 1024x1024 patch call (CFG 2 x sp 2), and its
        paths: the 2048x2048 decode at sp 4 and sp 2, SD 1.5's 512x512
        patch call."""
        launches = lambda line: line["flash_sdpa_d512_launches"]["lse"]  # noqa: E731
        decodes = {line["run"]: line for line in multi_runs["decode_sp"]}
        paths = {f"decode_2048_{name}": kernel_entry(
            rows_of(rows, f"vae_ring_2048_sp{line['n']}", "sdxl"), launches(line),
            work=f"one rank's sequence-parallel decode of a 2048x2048 latent ({name})")
            for name, line in decodes.items()}
        return kernel_entry(
            rows_of(rows, "vae_ring_1024_sp2", "sdxl"), launches(multi_runs["patch"][-1]),
            **{**FLASH_ENTRY, "name": "flash_sdpa[lse, d=512]"},
            work="the d = 512 log-sum-exp instance (float32 out and lse): the "
                 "sequence-parallel decode's ring in one rank's 4-step 1024x1024 patch "
                 "call at CFG 2 x sp 2; library: aten._scaled_dot_product_efficient_"
                 "attention with compute_log_sumexp",
            **paths, sd15_patch=kernel_entry(
                rows_of(rows, "vae_ring_512_sp2", "sd15"),
                launches(multi_runs["sd15_patch"][-1]),
                work="one rank's decode in SD 1.5's 512x512 patch call"))

    def d72_entries(rows, multi_runs, pixart=None, pipefusion=None, step=None):
        """The d = 72 instances (PixArt-α's DiT): the plain one in the dense
        1024x1024 call of the main path (``pixart``: its eager line, launches
        by head dim; without it, one rank of the "dit" run) with one rank of
        the "dit" run as a path, PipeFusion's one-card call (``pipefusion``:
        its graphed line) and rank 0 of each PipeFusion run that ran (over
        NCCL) as paths, and the log-sum-exp one in one rank of the
        "dit_ring" run; the decodes' d = 512 launches left out."""
        d512 = lambda line: line["flash_sdpa_d512_launches"]["lse"]  # noqa: E731
        # PipeFusion's ranks decode whole: the plain d = 512 instance once
        d72_only = lambda line: (line["flash_sdpa_launches"]  # noqa: E731
                                 - sum(line["flash_sdpa_d512_launches"].values()))
        dit, ring = multi_runs["dit"][-1], multi_runs["dit_ring"][-1]
        rank = path_entry(rows_of(rows, "patch_dit_self", "pixart"), [("patch_dit_self", 1)],
                          dit["flash_sdpa_launches"] - d512(dit),
                          work="one rank of the dit run (gather layout) at CFG 2 x sp 2, "
                               "4-step 1024x1024 PixArt call")
        plain_work = ("the d = 72 instance (PixArt-α's self-attention, 16 heads): ")
        if pixart is None:
            plain = {**rank, **FLASH_ENTRY, "name": "flash_sdpa[d=72]",
                     "work": plain_work + rank["work"]}
        else:
            plain = path_entry(
                rows_of(rows, "dit_self", "pixart"), [("dit_self", 1)],
                pixart["flash_sdpa_launches_by_head_dim"][72],
                **{**FLASH_ENTRY, "name": "flash_sdpa[d=72]"},
                work=plain_work + "all of it in one dense 4-step 1024x1024 PixArt call "
                                  "(eager launches by head dim; the graphed call launches as "
                                  "many); library: F.scaled_dot_product_attention",
                dit=rank)
        lse = path_entry(rows_of(rows, "dit_ring_hop", "pixart"), [("dit_ring_hop", 1)],
                         ring["flash_sdpa_lse_launches"] - d512(ring),
                           **{**FLASH_ENTRY, "name": "flash_sdpa[lse, d=72]"},
                           work="the d = 72 log-sum-exp instance (float32 out and lse): "
                                "the ring's chunks in one rank of the dit_ring run at CFG 2 x "
                                "sp 2, 4-step 1024x1024 PixArt call; library: the fastest of "
                                "aten's efficient, flash and cuDNN attention with the "
                                "log-sum-exp")
        knobs, ulysses = multi_runs["dit_knobs"][-1], multi_runs["dit_ulysses"][-1]
        usp = multi_runs["dit_usp"][-1]
        per_call = PIXART_STEPS * PIXART_DEPTH  # a row's launches in a 4-step call
        knob_attn = transformer_expected("dit_knobs", model_configs("pixart")[0])
        plain["dit_knobs"] = path_entry(
            rows_of(rows, "patch_dit_self", "pixart"),
            [("patch_dit_self", (knob_attn["flash_sdpa"] - sum(
                decode_launches(MULTI_RUNS["dit_knobs"][0], "pixart"))) / per_call)],
            knobs["flash_sdpa_launches"] - d512(knobs),
            work="one rank of the dit_knobs run (int8 refresh of every other row, the step "
                 "cache at interval 2 and depth 14) at CFG 2 x sp 2, 6-step 1024x1024 "
                 "PixArt call: 28 blocks in each of 4 full steps, 14 in each of 2 shallow")
        if pipefusion is not None:
            plain["pipefusion"] = path_entry(
                rows_of(rows, ("dit_self", "pipefusion_chunk@"), "pixart"),
                [("dit_self", 2 / PIXART_STEPS), ("pipefusion_chunk@", 1)],
                d72_only(pipefusion),
                work="PipeFusion's graphed 4-step 1024x1024 PixArt call on one card (one "
                     "stage, 4 chunks of 1024 tokens, warmup 1): 2 mega-patch passes at "
                     "the dense call's shape and 8 chunk passes (2, 1024 queries against "
                     "a block's 4096 cached keys) of 28 blocks")
        for label, weights, work in (
                ("pipefusion", [("dit_self", 14 / 112), ("pipefusion_chunk@", 56 / 224)],
                 "sp 4, CFG folded: 7 blocks in 2 mega-patch and 8 chunk passes"),
                ("pipefusion_cfg", [("pipefusion_warm_cfg", 1), ("pipefusion_chunk_cfg", 1)],
                 "CFG 2 x sp 2: 14 blocks in 2 mega-patch and 8 chunk passes at B = 1"),
                ("pipefusion_knobs", [("dit_self", 14 / 112),
                                      ("pipefusion_chunk@", 112 / 224)],
                 "sp 4, int8_residual hops, the step cache on the last stage, 6 steps: "
                 "7 blocks in 2 mega-patch and 16 chunk passes")):
            lines = multi_runs.get(label)
            if lines:
                plain[label] = path_entry(
                    rows_of(rows, ("dit_self", "pipefusion_"), "pixart"), weights,
                    d72_only(lines[0]),
                    work=f"rank 0 of the {label} run, graphed ({work})")
        plain["dit_ulysses"] = path_entry(
            rows_of(rows, "dit_ulysses_self", "pixart"), [("dit_ulysses_self", 1)],
            ulysses["flash_sdpa_launches"] - d512(ulysses),
            work="one rank of the dit_ulysses run at CFG 2 x sp 2, 4-step 1024x1024 "
                 "PixArt call: 8 heads of every token a block, q, k and v views of the "
                 "all-to-all's receive buffer")
        if step is not None:
            plain["pixart_step"] = path_entry(
                rows_of(rows, "step_dit_self", "pixart"), [("step_dit_self", step["dispatches"])],
                step["flash_launches"],
                work="the step drive's dispatches on the 1024x1024 PixArt pipeline at "
                     "batch_size 2 (eager, exec_mode 'step'): solo, joined, packed, parked "
                     "and resumed requests, every dispatch (4, 4096, 4096, 16, 72) in 28 "
                     "blocks")
        lse["dit_usp"] = path_entry(
            rows_of(rows, "dit_usp_chunk", "pixart"), [("dit_usp_chunk", 1)],
            usp["flash_sdpa_lse_launches"] - d512(usp),
            work="one rank of the dit_usp run at sp 4 (CFG folded), ulysses_degree 2, "
                 "4-step 1024x1024 PixArt call: per block and step a pair's 2048 tokens "
                 "on 8 heads against the own assembly and one hop")
        return [plain, lse]

    def sd3_entries(rows, multi_runs, sd3=None, sd35m=None, step=None):
        """SD3's d = 64 launches as paths of the flash entry: the dense
        1024x1024 call of the main path (``sd3``: its graphed line; the
        decode's d = 512 launch at the SD3 VAE's mid attention), one
        evaluation of the SD3.5-medium geometry (``sd35m``), one rank of the
        "sd3" run (gather, CFG 2 x sp 2; its decode's d = 512 ring); and the
        "sd3_ring" rank's log-sum-exp chunks, a path of the log-sum-exp
        entry."""
        decode = rows_of(rows, "vae_ring_1024_sp2", "sdxl")
        gather, ring = multi_runs["sd3"][-1], multi_runs["sd3_ring"][-1]
        plain = {"sd3_patch": path_entry(
            rows_of(rows, "patch_mmdit_joint", "sd3") + decode,
            [("patch_mmdit_joint", 1), ("vae_ring_1024_sp2", 1)],
            gather["flash_sdpa_launches"],
            work="one rank of the sd3 run (gather layout) at CFG 2 x sp 2, 4-step "
                 "1024x1024 SD3-medium call: the joint attention at 154 + 2048 queries "
                 "against 4250 keys, and the decode's ring")}
        knobs = multi_runs["sd3_knobs"][-1]
        knob_attn = transformer_expected("sd3_knobs", model_configs("sd3")[0])
        plain["sd3_knobs"] = path_entry(
            rows_of(rows, "patch_mmdit_joint", "sd3") + decode,
            [("patch_mmdit_joint", (knob_attn["flash_sdpa"] - sum(
                decode_launches(MULTI_RUNS["sd3_knobs"][0], "sd3"))) / (SD3_STEPS * 24)),
             ("vae_ring_1024_sp2", 1)],
            knobs["flash_sdpa_launches"],
            work="one rank of the sd3_knobs run (int8 refresh of every other row, the step "
                 "cache at interval 2 and depth 12) at CFG 2 x sp 2, 6-step 1024x1024 "
                 "SD3-medium call: 24 blocks in each of 4 full steps, 12 in each of 2 "
                 "shallow, and the decode's ring")
        if sd3 is not None:
            plain["sd3"] = path_entry(
                rows_of(rows, ("mmdit_joint", "vae_mid"), "sd3"),
                [("mmdit_joint", 1), ("vae_mid", 1)], sd3["flash_sdpa_launches"],
                work="one graphed 4-step 1024x1024 SD3-medium call: the joint attention "
                     "(2, 4250, 4250, 24, 64) in 24 blocks a step and the whole decode")
        if sd35m is not None:
            plain["sd35m"] = path_entry(
                rows_of(rows, ("mmdit_joint", "mmdit35m_dual"), "sd3"),
                [("mmdit_joint", 1 / SD3_STEPS), ("mmdit35m_dual", 1)],
                sd35m["flash_sdpa_launches"],
                work="one evaluation of the SD3.5-medium geometry at 1024x1024: 24 joint "
                     "attentions and 13 image-only dual attentions (2, 4096, 4096, 24, 64)")
        if step is not None:
            plain["sd3_step"] = path_entry(
                rows_of(rows, "step_mmdit_joint", "sd3"),
                [("step_mmdit_joint", step["dispatches"])], step["flash_launches"],
                work="the step drive's dispatches on the 1024x1024 SD3-medium pipeline at "
                     "batch_size 2 (eager, exec_mode 'step'): every dispatch the joint "
                     "attention (4, 4250, 4250, 24, 64) in 24 blocks")
        lse = path_entry(
            rows_of(rows, "sd3_ring", "sd3") + decode,
            [("sd3_ring", 1), ("vae_ring_1024_sp2", 1)], ring["flash_sdpa_lse_launches"],
            work="one rank of the sd3_ring run at CFG 2 x sp 2, 4-step 1024x1024 "
                 "SD3-medium call: per block and step the own chunk and one hop (154 + "
                 "2048 queries against 2048 keys) and the static context block (against "
                 "154 keys), and the decode's ring")
        return plain, {"sd3_ring": lse}

    def knob_entry(rows, label, lines):
        """The flash kernel in one call of a comm-knob run on one rank: the
        ring's chunks at the log-sum-exp rows, every other attention at the
        patch rows (a shallow step runs level 1's only)."""
        fields, _, counts, _, steps = MULTI_RUNS[label]
        full = counts["sync"] + counts["stale"]
        decode = ("vae_ring_1024_sp2", 1)
        if label == "ring":
            weights = [("ring_hop", 1), ("patch_unet_cross", full / 4), decode]
        elif "shallow" in counts:
            weights = [("patch_unet_self_l1", (full + counts["shallow"]) / 4),
                       ("patch_unet_cross_l1", (full + counts["shallow"]) / 4),
                       ("patch_unet", full / 4), decode]
        else:
            weights = [("patch_unet", full / 4), decode]
        picked = rows_of(rows, ("ring_hop", "patch_unet", "vae_ring_1024"), "sdxl")
        return path_entry(picked, weights, lines[-1]["flash_sdpa_launches"],
                          work=f"one rank of the {label} run ({fields}) at CFG 2 x sp 2, "
                               f"{steps}-step 1024x1024 call")

    def instance_entries(rows, by_head_dim, work):
        """One entry per SD 1.5 instance: its rows, the launches counted
        by head dim in the main path's eager call."""
        by_head_dim = {int(d): n for d, n in by_head_dim.items()}
        return [kernel_entry([r for r in rows if r["d"] == d], by_head_dim.get(d, 0),
                             **{**FLASH_ENTRY, "name": f"flash_sdpa[d={d}]"},
                             work=f"the d = {d} instance: " + work)
                for d in SD15_HEAD_DIMS]

    def knob_kernels(lse_rows, refresh_rows, multi_runs, hop_rows=()):
        """The kernels line's entries for the comm-knob runs: the flash
        kernel's log-sum-exp instances (the ring run's chunks), and the
        refresh codec's encoder (quantize_rows) and decoder
        (dequantize_rows) at the refresh payloads (compress_pcpp, int8, one
        launch a payload; stepcache_batch, fp8, one a flush); raises unless
        the rows' launches add up to the counts the runs read."""
        ring = multi_runs["ring"][-1]
        lse = kernel_entry(lse_rows, ring["flash_sdpa_lse_launches"]
                           - ring["flash_sdpa_d512_launches"]["lse"],
                           **{**FLASH_ENTRY, "name": "flash_sdpa[lse]"},
                           work="the log-sum-exp instances (float32 out and lse) in one "
                                "rank's 4-step 1024x1024 ring call at CFG 2 x sp 2 (the "
                                "decode's d = 512 ones apart); library: the fastest of "
                                "aten's efficient, flash and cuDNN attention with the "
                                "log-sum-exp")

        def codec(label, prefix):
            picked = [r for r in refresh_rows if r["shape"].startswith(f"refresh_{label}_")]
            launches = multi_runs[label][-1][prefix + "rows_launches"]
            if sum(r["launches_per_call"] for r in picked) != launches:
                raise AssertionError(f"{label}: {launches} {prefix}rows launches read, the "
                                     "payload rows account for "
                                     f"{sum(r['launches_per_call'] for r in picked)}")
            return kernel_entry(picked, launches, prefix,
                                work=f"the refresh payloads of one rank's {label} call "
                                     f"({MULTI_RUNS[label][0]}), bf16 sources; no library "
                                     "call")

        labels = ("compress_pcpp", "stepcache_batch", *TRANSFORMER_KNOB_RUNS)
        quant = {label: codec(label, "quantize_") for label in labels}
        dequant = {label: codec(label, "dequantize_") for label in labels}
        lines = multi_runs.get("pipefusion_knobs")
        if lines:  # rank 0's hops: the residual code of one chunk an item
            residual = [r for r in hop_rows if r.get("residual")]
            work = ("the hops of rank 0 of the pipefusion_knobs run (int8_residual: "
                    "float32 chunks [2, 1024, 1152] against a float32 predictor)")
            quant["pipefusion_knobs"] = kernel_entry(
                residual, lines[0]["quantize_rows_launches"], "quantize_", work=work)
            dequant["pipefusion_knobs"] = kernel_entry(
                [{**r, "launches_per_call": r["dequantize_launches_per_call"]}
                 for r in residual], lines[0]["dequantize_rows_launches"], "dequantize_",
                work=work)
        dequant = {**dequant.pop("compress_pcpp"), **DEQUANT_ENTRY, **dequant}
        return lse, quant, dequant

    seconds, t0 = {}, time.perf_counter()
    if args.serve_only:
        rows = kernel_phase(serve_shapes, spills)
        qrows = quant_kernel_phase(serve_qshapes)
        seconds["serve_kernel_rows"], t0 = time.perf_counter() - t0, time.perf_counter()
        trees = build_trees()
        serve = serve_phase(trees, steps, expected_flash, expected_quant)
        seconds["serve"], t0 = time.perf_counter() - t0, time.perf_counter()
        staged = staged_phase(trees, steps, expected_flash)
        seconds["serve_staged"], t0 = time.perf_counter() - t0, time.perf_counter()
        step = step_phase(trees)
        seconds["serve_step"] = time.perf_counter() - t0
        plane, plane_s = plane_phases(trees)
        seconds.update(plane_s)
        del trees
        print(json.dumps({"phase": "seconds", **seconds}), flush=True)
        flash, quant = serve_kernels(rows, qrows, serve)
        sflash, squant = step_serve_kernels(rows, qrows, staged, step)
        pflash = plane_kernels(rows, plane)
        print(json.dumps({"serve": serve}), flush=True)
        return finish([{**flash.pop("serve"), **FLASH_ENTRY, **flash, **sflash, **pflash},
                       {**quant["quant_matmul"], "name": "quant_matmul", "route": "cuda",
                        "source": "distrifuser_tpu_torch/csrc/quant_matmul.cu",
                        "replaces": "distrifuser_tpu/ops/quant_matmul.py:54",
                        "serve_step_int8": squant["quant_matmul"]},
                       {**quant["quantize_rows"], **QUANT_ENTRY,
                        "serve_step_int8": squant["quantize_rows"]}])
    if args.patch_only and args.runs:
        patch_phase(None, os.path.join(args.out_dir, "multi"), profile=args.profile,
                    runs=args.runs.split(","))
        print(json.dumps({"phase": "seconds", "multi_rank": time.perf_counter() - t0}),
              flush=True)
        return finish(None)
    if args.patch_only:
        rows = (kernel_phase(multi + vae_rows + list(PIXART_SHAPES[:3]) + shapes3[1:2]
                             + list(PIPEFUSION_SHAPES), spills)
                + lse_kernel_phase(spills, PIXART_RING_HOPS + tuple(hops3)))
        refresh_rows = refresh_codec_phase(refresh_codec_rows(ucfg, 1024, 1024))
        hop_rows = hop_codec_phase()
        seconds["flash_kernel_multi_rank_shapes"], t0 = (time.perf_counter() - t0,
                                                         time.perf_counter())
        multi_runs = patch_phase(None, os.path.join(args.out_dir, "multi"),
                                 profile=args.profile)
        seconds["multi_rank"] = time.perf_counter() - t0
        print(json.dumps({"phase": "seconds", **seconds}), flush=True)
        subs = multi_entries(rows, multi_runs)
        lse, refresh, dequant = knob_kernels(rows_of(rows, "ring_hop", "sdxl"), refresh_rows,
                                             multi_runs, hop_rows)
        sd3_plain, sd3_lse = sd3_entries(rows, multi_runs)
        sr_flash, sr_d512, sr_quant, sr_dequant = serve_ranks_entries(rows, refresh_rows,
                                                                      multi_runs)
        kernels = [{**subs.pop("patch"), **FLASH_ENTRY, **subs, **sd3_plain, **sr_flash,
                    **ranks_recover_entries(rows, multi_runs)},
                   {**lse, **sd3_lse},
                   {**d512_entry(rows, multi_runs), "serve_ranks": sr_d512},
                   {**refresh.pop("compress_pcpp"), **QUANT_ENTRY, **refresh,
                    "serve_ranks_comm_compress": sr_quant},
                   {**dequant, "serve_ranks_comm_compress": sr_dequant},
                   *instance_entries(rows_of(rows, "patch_", "sd15"),
                                     multi_runs["sd15_patch"][0]
                                     ["flash_sdpa_launches_by_head_dim"],
                                     "one rank of SD 1.5's patch path at CFG 2 x sp 2 "
                                     "(stale_gn), 4-step 512x512 call, eager"),
                   *d72_entries(rows, multi_runs)]
        return finish(kernels)
    rows = kernel_phase(shapes + shapes15 + shapes21 + multi + enc_rows + decode_rows
                        + list(PIXART_SHAPES) + shapes3 + list(PIPEFUSION_SHAPES)
                        + serve_shapes + [STEP_DIT_SHAPE, STEP_MMDIT_SHAPE], spills)
    rows += lse_kernel_phase(spills, PIXART_RING_HOPS + tuple(hops3))
    mrows = rows
    rows = rows_of(mrows, ("unet", "vae_mid"), "sdxl")
    rows15 = rows_of(mrows, ("unet", "vae_mid"), "sd15")
    rows21 = rows_of(mrows, ("unet", "vae_mid"), "sd21")
    seconds["flash_kernel"], t0 = time.perf_counter() - t0, time.perf_counter()
    qshapes15 = quant_shapes(ucfg15, size15, size15, steps, suffix=SD15)
    per_forward15, per_call15 = unet.linear_calls(ucfg15)
    expected_quant15 = steps * per_forward15 + per_call15
    assert sum(s[-1] for s in qshapes15) == expected_quant15, (qshapes15, expected_quant15)
    qrows = quant_kernel_phase(qshapes + qshapes15 + pixart_quant_shapes()
                               + sd3_quant_shapes() + serve_qshapes)
    refresh_rows = refresh_codec_phase(refresh_codec_rows(ucfg, 1024, 1024))
    hop_rows = hop_codec_phase()
    seconds["quant_kernel"], t0 = time.perf_counter() - t0, time.perf_counter()
    for weight_quant in ("none", "int8", "fp8"):
        print(json.dumps(tiny_check(weight_quant)), flush=True)
    print(json.dumps(tiny_check(model="sd15", scheduler="euler")), flush=True)
    print(json.dumps(tiny_check(model="pixart", scheduler="dpm-solver")), flush=True)
    print(json.dumps(tiny_check(model="pixart", scheduler="dpm-solver", steps=PIXART_STEPS,
                                parallelism="pipefusion", pipe_patches=PIPEFUSION_PATCHES,
                                warmup_steps=PATCH_WARMUP)), flush=True)
    for model, weight_quant in (("sd3", "none"), ("sd3", "int8"), ("sd35m", "none")):
        print(json.dumps(tiny_check(weight_quant, model=model)), flush=True)
    print(json.dumps(stepcache_graph_check()), flush=True)
    seconds["tiny_checks"], t0 = time.perf_counter() - t0, time.perf_counter()
    trees = build_trees()
    runs, dense_latent = pipeline_phase(trees, expected_flash, expected_quant)
    seconds["pipelines_eager_and_graphed_img2img_handoff_save_load"], t0 = (
        time.perf_counter() - t0, time.perf_counter())
    flops_phase(trees)
    seconds["flops"], t0 = time.perf_counter() - t0, time.perf_counter()
    decodes = tiled_decode_phase(trees)
    seconds["tiled_decode"], t0 = time.perf_counter() - t0, time.perf_counter()
    serve = serve_phase(trees, steps, expected_flash, expected_quant)
    seconds["serve"], t0 = time.perf_counter() - t0, time.perf_counter()
    staged = staged_phase(trees, steps, expected_flash)
    seconds["serve_staged"], t0 = time.perf_counter() - t0, time.perf_counter()
    step = step_phase(trees)
    seconds["serve_step"], t0 = time.perf_counter() - t0, time.perf_counter()
    plane, plane_s = plane_phases(trees)
    del trees
    seconds.update(plane_s)
    t0 = time.perf_counter()
    sd_runs = sd_pipeline_phase(by_head_dim15, expected_quant15)
    seconds["sd_pipelines"], t0 = time.perf_counter() - t0, time.perf_counter()
    pixart = pixart_phase()
    seconds["pixart"], t0 = time.perf_counter() - t0, time.perf_counter()
    sd3 = sd3_phase()
    sd35m = sd35m_phase()
    seconds["sd3_and_sd35m_geometry"], t0 = time.perf_counter() - t0, time.perf_counter()
    cli = cli_phase()
    seconds["cli"], t0 = time.perf_counter() - t0, time.perf_counter()
    multi_runs = patch_phase(dense_latent, os.path.join(args.out_dir, "multi"))
    seconds["multi_rank"] = time.perf_counter() - t0
    print(json.dumps({"phase": "seconds", **seconds}), flush=True)

    by_mode = {mode: [r for r in qrows if r["mode"] == mode and family(r["shape"]) == "sdxl"]
               for mode in ("int8", "fp8")}
    by_mode15 = {mode: [r for r in qrows if r["mode"] == mode and family(r["shape"]) == "sd15"]
                 for mode in ("int8", "fp8")}
    xl_rows = rows_of(mrows, ("unet", "vae_mid", "i2i", "decode2048"), "sdxl")
    paths = {
        "img2img": path_entry(xl_rows, [("unet", 0.5), ("vae_mid", 1),
                                        ("i2i_vae_encoder_mid", 1)],
                              runs["img2img_graphed"]["flash_sdpa_launches"],
                              work="one graphed 1024x1024 SDXL img2img call, strength 0.5 "
                                   "of 4 steps: 2 UNet steps, the encoder and the decoder"),
        "handoff": path_entry(xl_rows, [("unet", 1)],
                              runs["handoff_graphed"]["flash_sdpa_launches"],
                              work="the graphed handoff at 0.5: a call to step 2 and one "
                                   "from step 2 to latents, 1024x1024"),
        "refiner": path_entry(xl_rows, [("unet", 0.5), ("vae_mid", 1)],
                              runs["refiner"]["flash_sdpa_launches"],
                              work="one refiner-layout call from step 2 of 4 to an image"),
        "decode_2048_tiled": path_entry(xl_rows, [("vae_mid", 5)],
                                        decodes["tiled"]["flash_sdpa_launches"],
                                        work="the row-tiled decode of a 2048x2048 latent: "
                                             "5 tiles of 64 rows"),
        "decode_2048_whole": path_entry(xl_rows, [("decode2048", 1)],
                                        decodes["whole"]["flash_sdpa_launches"],
                                        work="the whole-latent decode of a 2048x2048 latent"),
        "cli_run_sdxl": path_entry(xl_rows, [("unet", 4)],
                                   cli["run_sdxl"]["flash_sdpa_launches"],
                                   work="run_sdxl --mode benchmark: 4 graphed 4-step "
                                        "1024x1024 calls to latents"),
        "cli_sd_example": path_entry(
            rows15 + rows_of(mrows, "i2i", "sd15"),
            [("unet", 0.5), ("i2i_vae_encoder_mid", 1), ("vae_mid", 1)],
            cli["sd_example"]["flash_sdpa_launches"],
            work="sd_example img2img at 512x512, strength 0.5 of 4 steps"),
    }
    per_call = ("(per-shape time x launches per call) at weight_quant='int8'; 'fp8' "
                "holds the same for fp8")
    lse, refresh, dequant = knob_kernels(rows_of(mrows, "ring_hop", "sdxl"), refresh_rows,
                                         multi_runs, hop_rows)
    sd3_plain, sd3_lse = sd3_entries(mrows, multi_runs, sd3[1], sd35m, sd3[2])
    serve_flash, serve_quant = serve_kernels(mrows, qrows, serve)
    step_flash, step_quant = step_serve_kernels(mrows, qrows, staged, step)
    plane_flash = plane_kernels(mrows, plane)
    sr_flash, sr_d512, sr_quant, sr_dequant = serve_ranks_entries(mrows, refresh_rows,
                                                                  multi_runs)
    kernels = [
        kernel_entry(rows, runs["dense"]["flash_sdpa_launches"], **FLASH_ENTRY,
                     work="all attention of one 4-step 1024x1024 SDXL pipeline call "
                          "under CUDA graphs (per-shape time x launches per call); "
                          "'patch', 'naive_patch', 'tensor' and 'sd15_patch' hold the "
                          "same for one rank of each multi-rank run (eager: its ranks "
                          "share the card); 'sd15' for one 4-step 512x512 SD 1.5 call "
                          "and 'sd21' for one 4-step 768x768 SD 2.1 call, each under "
                          "CUDA graphs",
                     **multi_entries(mrows, multi_runs),
                     sd15=kernel_entry(rows15, sd_runs["sd15"]["flash_sdpa_launches"]),
                     sd21=kernel_entry(rows21, sd_runs["sd21"]["flash_sdpa_launches"]),
                     **paths, **sd3_plain, **serve_flash, **step_flash, **plane_flash,
                     **sr_flash, **ranks_recover_entries(mrows, multi_runs)),
        *instance_entries(rows15, sd_runs["sd15_eager"]["flash_sdpa_launches_by_head_dim"],
                          "all its attention in one 4-step 512x512 SD 1.5 call (launches "
                          "counted in the eager call; the graphed one launches as many)"),
        kernel_entry(by_mode["int8"], runs["int8"]["quant_matmul_launches"], "fused_",
                     name="quant_matmul", route="cuda",
                     source="distrifuser_tpu_torch/csrc/quant_matmul.cu",
                     replaces="distrifuser_tpu/ops/quant_matmul.py:54",
                     work="all quantized linears of one 4-step 1024x1024 SDXL pipeline "
                          "call under CUDA graphs in the fused form the path runs (sx, "
                          "bf16 cast, bias in the epilogue) " + per_call + "; library: "
                          "torch._int_mm (the int8 product alone) and, for fp8, "
                          "torch._scaled_mm with row-wise scales and bf16 output; "
                          "'contract' holds the fp32 contract form's per-shape times "
                          "weighted by the same launches per call, a form the path does "
                          "not run (library: the product alone)",
                     fp8=kernel_entry(by_mode["fp8"], runs["fp8"]["quant_matmul_launches"],
                                      "fused_"),
                     contract={mode: kernel_entry(by_mode[mode], None) for mode in by_mode},
                     serve_int8=serve_quant["quant_matmul"],
                     serve_step_int8=step_quant["quant_matmul"],
                     **{f"sd15_{mode}": kernel_entry(
                         by_mode15[mode], sd_runs[f"sd15_{mode}"]["quant_matmul_launches"],
                         "fused_", work=f"one graphed 4-step 512x512 SD 1.5 call at {mode}",
                         contract=kernel_entry(by_mode15[mode], None))
                        for mode in by_mode15}),
        kernel_entry(by_mode["int8"], runs["int8"]["quantize_rows_launches"], "quantize_",
                     **QUANT_ENTRY,
                     work="per-token quantization of every quantized linear's "
                          "activation in one call under CUDA graphs " + per_call + "; no "
                          "Pallas kernel: the JAX package leaves quantize to XLA; plain "
                          "version compress.quantize; no single library call",
                     fp8=kernel_entry(by_mode["fp8"], runs["fp8"]["quantize_rows_launches"],
                                      "quantize_"),
                     serve_int8=serve_quant["quantize_rows"],
                     serve_step_int8=step_quant["quantize_rows"],
                     **{f"sd15_{mode}": kernel_entry(
                         by_mode15[mode], sd_runs[f"sd15_{mode}"]["quantize_rows_launches"],
                         "quantize_", work=f"one graphed 4-step 512x512 SD 1.5 call at {mode}")
                        for mode in by_mode15},
                     **refresh, serve_ranks_comm_compress=sr_quant),
        {**dequant, "serve_ranks_comm_compress": sr_dequant},
        {**lse, **sd3_lse},
        {**d512_entry(mrows, multi_runs), "serve_ranks": sr_d512},
        *d72_entries(mrows, multi_runs, pixart[0], pixart[2], pixart[3]),
    ]
    print(json.dumps({"serve": serve}), flush=True)
    return finish(kernels)


def finish(kernels) -> int:
    """The last three lines: the card, the kernels (None: no kernels line),
    the result."""
    import torch

    print(card_line(), flush=True)
    if kernels is not None:
        print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
