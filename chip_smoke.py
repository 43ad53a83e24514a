#!/usr/bin/env python3
"""Drive the PyTorch / H100 port on one CUDA card and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. print the card's name and power limit (nvidia-smi) and build every
   kernel of the path from this checkout's sources (one nvcc per source,
   sm_90a, started together), with each one's ptxas report;
2. flash kernel phase: at every shape SDXL 1024x1024 gives the
   flash-attention kernel (derived from the UNet and VAE configs), hold the
   kernel against its plain PyTorch version on seeded bf16 inputs (max |d|
   <= 2e-2, mean |d| <= 2e-3: a few bf16 roundings of outputs below 1) and
   time the kernel, the plain version and F.scaled_dot_product_attention
   (a yardstick only; the port never calls it) with CUDA events over
   back-to-back calls, and the kernel and SDPA also by their device time
   under torch.profiler (short kernels are host-bound back to back); each row
   also names the kernel instance it ran (registers per thread as
   compiled, shared memory bytes, threads, tile sizes) and the host time
   of one wrapper call (checks, tensor-map encoding, launch), taken while
   enqueuing 50 calls that the card has not finished;
3. quant kernel phase: at every (M, K, N) the quantized main path gives
   the quantized-matmul kernel (derived from the UNet config), and at odd
   shapes, for int8 and fp8, hold the kernel against its plain version on
   seeded inputs quantized by the port (int8 bit-identical; fp8 max |d| <=
   2e-3 * max |ref|, below the bf16 rounding its caller applies next),
   and time the kernel, the plain version and the library GEMM
   (torch._int_mm / torch._scaled_mm, a yardstick only);
4. small-input checks: the tiny SDXL pipeline in bf16 on the card against
   the same pipeline in float32 on the CPU, same weights and latents:
   dense (relative L2 of the latents <= 8e-2; 2.3e-2 measured for bf16 vs
   float32 on a CPU), and with weight_quant int8 / fp8 under
   quant_compute="pallas" (the kernel on the card, its plain version on the
   CPU; <= 8e-2 and <= 2.5e-1, 4.4e-2 and 1.3e-1 measured for bf16 vs
   float32 on a CPU: fp8's 3 mantissa bits round bf16 and float32
   activations differently);
5. main path: DistriSDXLPipeline at full SDXL width (UNet, ViT-L + bigG
   text encoders, SDXL VAE; seeded random bf16 weights), one prompt,
   4 DDIM steps at 1024x1024 -> a finite (1024, 1024, 3) image, three
   times: dense; weight_quant="int8" with weight_quant_aux="int8"; and
   weight_quant="fp8".  The quantized runs use quant_compute="pallas".
   Each pipeline makes one untimed call first (kernel loading, algorithm
   choice), then the measured one.
   Every launch count is set to 0 just before each call and read just
   after it: flash 4*140 + 1 in each, quant_matmul 0 in the dense call and
   4*533 + 70 in each quantized one (derived from the config).

It prints one JSON line per kernel shape, a card line, the kernels line,
and last the line {"ok": true, "device": {...}}.  It exits non-zero
without a result when no CUDA card is present or the package is missing.
"""

import json
import math
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_8BIT_OPS = 1979e12  # H100 SXM dense int8 / fp8 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
KERNEL_MAX_ABS, KERNEL_MEAN_ABS = 2e-2, 2e-3
QUANT_FP8_REL = 2e-3
HOST_CALLS = 50  # wrapper calls whose host time is taken per flash shape
TINY_REL_L2 = {"none": 8e-2, "int8": 8e-2, "fp8": 2.5e-1}
ODD_QUANT_SHAPES = ((33, 72, 50), (64, 64, 48), (128, 256, 130), (17, 2816, 320))
CHECK_DEVICES = (("cpu", "float32"), ("cuda", "bfloat16"))
TEXT_LEN = 77
PROMPT = "a photo of an astronaut riding a horse on mars"


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


def device_ms(fn, iters=20):
    """Mean device time per call: the CUDA kernels' own time under
    torch.profiler over ``iters`` calls after one warm-up, without the host
    gaps that back-to-back timing of a short kernel includes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / iters / 1e3


def attention_shapes(ucfg, vcfg, height, width, unet_evals):
    """Every (B, Lq, Lk, heads, d) the main path gives the kernel, with its
    launch count for one pipeline call: per UNet level a self- and a
    cross-attention for each transformer block (CFG folds B to 2), and the
    VAE's single-head mid attention at the latent resolution (B = 1)."""
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
        shapes.append((f"unet_self_l{lvl}", 2, tokens, tokens, heads, d, count * unet_evals))
        shapes.append((f"unet_cross_l{lvl}", 2, tokens, TEXT_LEN, heads, d,
                       count * unet_evals))
    top = vcfg.block_out_channels[-1]
    shapes.append(("vae_mid", 1, lh * lw, lh * lw, 1, top, 1))
    return shapes


def kernel_phase(shapes):
    import torch
    import torch.nn.functional as F

    from distrifuser_tpu_torch.ops import flash_attention as fa

    results = []
    for name, b, lq, lk, heads, d, calls in shapes:
        c = heads * d
        g = torch.Generator(device="cuda").manual_seed(len(results))
        q = torch.randn(b, lq, c, device="cuda", generator=g).bfloat16()
        if name.startswith("vae"):  # separate to_q/to_k/to_v projections
            k = torch.randn(b, lk, c, device="cuda", generator=g).bfloat16()
            v = torch.randn(b, lk, c, device="cuda", generator=g).bfloat16()
        else:  # strided views of the fused to_kv output
            k, v = torch.randn(b, lk, 2 * c, device="cuda", generator=g).bfloat16().chunk(2, -1)
        got = fa.flash_sdpa(q, k, v, heads=heads)
        want = fa.flash_sdpa_reference(q, k, v, heads=heads)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        if not (max_err <= KERNEL_MAX_ABS and mean_err <= KERNEL_MEAN_ABS):
            raise AssertionError(f"flash_sdpa {name}: max |d| {max_err}, mean |d| "
                                 f"{mean_err} over {KERNEL_MAX_ABS}/{KERNEL_MEAN_ABS}")

        def kernel():
            return fa.flash_sdpa(q, k, v, heads=heads)

        ms = time_ms(kernel)
        t_host = time.perf_counter()  # enqueue only: the card drains afterwards
        for _ in range(HOST_CALLS):
            kernel()
        host_us = (time.perf_counter() - t_host) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
        plain_ms = time_ms(lambda: fa.flash_sdpa_reference(q, k, v, heads=heads),
                           max_iters=10)
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
        }
        print(json.dumps(row), flush=True)
        results.append(row)
        del q, k, v, got, want, err
        torch.cuda.empty_cache()
    return results


def quant_shapes(ucfg, height, width, steps, batch=2):
    """Every (name, M, K, N, launches per pipeline call) the quantized main
    path gives the quantized-matmul kernel: per UNet level with transformer
    blocks (tokens x batch rows; CFG folds the batch to 2) the attention
    to_q / to_out and the linear proj_in / proj_out, the self-attention
    to_kv, the GEGLU projection and the FF output, once per step; the
    cross-attention to_kv on the text tokens, once per call; and the time
    and add embeddings and each resnet's time_emb_proj on ``batch`` rows."""
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
    return shapes


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


def quant_kernel_phase(shapes):
    import torch

    from distrifuser_tpu_torch.ops import quant_matmul as qm
    from distrifuser_tpu_torch.parallel.compress import quantize, quantize_weight

    odd = [(f"odd_{m}x{k}x{n}", m, k, n, 0) for m, k, n in ODD_QUANT_SHAPES]
    results = []
    for name, m, k, n, calls in list(shapes) + odd:
        for mode in ("int8", "fp8"):
            g = torch.Generator(device="cuda").manual_seed(len(results))
            x = torch.randn(m, k, device="cuda", generator=g).bfloat16()
            w = (torch.randn(k, n, device="cuda", generator=g) / k**0.5).bfloat16()
            xq, _ = quantize(x, mode)
            qt = quantize_weight(w, mode)
            wq, sw = qt.payload, qt.channel_scale()
            got = qm.quant_matmul(xq, wq, sw)
            want = qm.quant_matmul_reference(xq, wq, sw)
            torch.cuda.synchronize()
            ref_max = want.abs().max().item()
            max_err = (got - want).abs().max().item()
            row = {"shape": name, "mode": mode, "M": m, "K": k, "N": n,
                   "launches_per_call": calls, "max_abs_err": max_err,
                   "max_abs_ref": ref_max}
            if mode == "int8":
                if not torch.equal(got, want):
                    raise AssertionError(f"quant_matmul int8 {name}: not bit-identical "
                                         f"to the plain version (max |d| {max_err})")
            elif max_err > QUANT_FP8_REL * ref_max:
                raise AssertionError(f"quant_matmul fp8 {name}: max |d| {max_err} "
                                     f"over {QUANT_FP8_REL} * {ref_max}")
            row["ms"] = time_ms(lambda: qm.quant_matmul(xq, wq, sw), target_ms=100)
            row["plain_ms"] = time_ms(lambda: qm.quant_matmul_reference(xq, wq, sw),
                                      target_ms=100, max_iters=10)
            try:
                row["library_ms"] = time_ms(_library_gemm(xq, wq), target_ms=100)
            except RuntimeError as e:  # no library kernel for this shape
                print(f"library gemm unavailable at {name}/{mode}: {e}", file=sys.stderr)
                row["library_ms"] = None
            ops = 2.0 * m * k * n
            nbytes = m * k + k * n + 4.0 * n + 4.0 * m * n  # xq, wq, sw in; fp32 out
            ops_ms, bytes_ms = ops / PEAK_8BIT_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
            row.update(bound_ms=max(ops_ms, bytes_ms),
                       bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                       tops=ops / (row["ms"] * 1e-3) / 1e12)
            print(json.dumps(row), flush=True)
            results.append(row)
            del x, w, xq, qt, wq, sw, got, want
            torch.cuda.empty_cache()
    return results


def tiny_check(weight_quant="none"):
    """Tiny SDXL pipeline: bf16 on the card (kernels) vs float32 on the CPU
    (plain versions), same weights and latents; a quantized check
    quantizes the same dense weights on each side."""
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
    trees = (unet.init_unet_params(gen, ucfg), vae.init_vae_params(gen, vcfg),
             [clip.init_clip_params(gen, tc) for tc in tcfgs])
    latents = np.random.RandomState(0).randn(1, 16, 16, 4).astype(np.float32)
    quant = {} if weight_quant == "none" else {"weight_quant": weight_quant,
                                                "quant_compute": "pallas"}
    outs = []
    for device, dtype in CHECK_DEVICES:
        dtype = getattr(torch, dtype)
        u, v = (cast_params(t, dtype, device) for t in trees[:2])
        ts = [cast_params(t, dtype, device) for t in trees[2]]
        cfg = DistriConfig(device=device, height=128, width=128, **quant)
        pipe = DistriSDXLPipeline.from_params(cfg, ucfg, u, vcfg, v, tcfgs, ts)
        outs.append(pipe("a lighthouse at dusk", num_inference_steps=3,
                         latents=latents, output_type="latent").images[0])
    ref, got = outs
    if not np.isfinite(got).all():
        raise AssertionError("tiny pipeline on the card gave non-finite latents")
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    limit = TINY_REL_L2[weight_quant]
    result = {"phase": "tiny_check", "weight_quant": weight_quant, "rel_l2": rel,
              "max_abs": float(np.abs(got - ref).max()), "limit_rel_l2": limit}
    print(json.dumps(result), flush=True)
    if rel > limit:
        raise AssertionError(f"tiny pipeline ({weight_quant}) bf16/card vs fp32/cpu "
                             f"rel L2 {rel} over {limit}")


def build_sdxl_trees():
    """Full-width SDXL configs and seeded random bf16 parameter trees on the
    first card: (unet config, unet tree, vae config, vae tree, text
    configs, text trees)."""
    import torch

    from distrifuser_tpu_torch.models import clip, unet, vae

    gen = torch.Generator(device="cuda").manual_seed(0)
    ucfg, vcfg = unet.sdxl_config(), vae.sdxl_vae_config()
    tcfgs = [clip.clip_vit_l_config(), clip.open_clip_bigg_config()]
    dtype = torch.bfloat16
    return (ucfg, unet.init_unet_params(gen, ucfg, dtype), vcfg,
            vae.init_vae_params(gen, vcfg, dtype), tcfgs,
            [clip.init_clip_params(gen, tc, dtype) for tc in tcfgs])


def build_sdxl_pipeline(trees, **quant):
    """DistriSDXLPipeline at 1024x1024 on the first card (bf16) from
    ``trees``, quantized at load time under the ``quant`` config fields;
    returns (pipeline, seconds to build)."""
    import torch

    from distrifuser_tpu_torch import DistriConfig, DistriSDXLPipeline

    t_init = time.perf_counter()
    ucfg, unet_p, vcfg, vae_p, tcfgs, text_p = trees
    cfg = DistriConfig(height=1024, width=1024, **quant)  # first CUDA card, bf16
    pipe = DistriSDXLPipeline.from_params(cfg, ucfg, unet_p, vcfg, vae_p, tcfgs, text_p)
    torch.cuda.synchronize()
    return pipe, time.perf_counter() - t_init


def pipeline_run(pipe, init_s, label, expected):
    """One 4-step 1024x1024 call with every launch count set to 0 just
    before it and read just after it; checks the image and the counts
    against ``expected`` and returns (result line, final latent)."""
    import numpy as np
    import torch

    from distrifuser_tpu_torch.ops import flash_attention as fa
    from distrifuser_tpu_torch.ops import quant_matmul as qm

    marks, last = [], {}

    def on_step(i, t, x):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        last["x"] = x

    torch.cuda.reset_peak_memory_stats()
    fa.flash_sdpa.launches = 0
    qm.quant_matmul.launches = 0
    t0 = time.perf_counter()
    out = pipe(PROMPT, num_inference_steps=4, seed=0, output_type="np",
               callback=on_step)
    total_s = time.perf_counter() - t0
    launches = {"flash_sdpa": fa.flash_sdpa.launches,
                "quant_matmul": qm.quant_matmul.launches}
    img = out.images[0]
    if img.shape != (1024, 1024, 3) or not np.isfinite(img).all():
        raise AssertionError(f"{label}: image shape {img.shape}, finite "
                             f"{np.isfinite(img).all()}")
    if launches != expected:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {expected}")
    pixels = (img * 255).round().astype(np.uint8)
    steps = [(marks[i] - marks[i - 1]) * 1e3 for i in range(1, len(marks))]
    report = pipe.weight_report()
    result = {
        "phase": "pipeline", "run": label,
        "model": "SDXL-base widths, random bf16 weights",
        "weight_quant": report["weight_quant"],
        "weight_quant_aux": report["weight_quant_aux"],
        "quant_compute": report["quant_compute"],
        "height": 1024, "width": 1024, "steps": 4, "prompts": 1,
        "init_s": init_s, "total_s": total_s,
        "first_step_ms_incl_text_encode": (marks[0] - t0) * 1e3,
        "step_ms": steps, "decode_and_copy_ms": (t0 + total_s - marks[-1]) * 1e3,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "weight_bytes": report["per_component_nbytes"],
        "flash_sdpa_launches": launches["flash_sdpa"],
        "quant_matmul_launches": launches["quant_matmul"],
        "pixel_mean": float(pixels.mean()),
    }
    return result, last["x"].float().cpu().numpy()


def pipeline_phase(expected_flash, expected_quant):
    """The main path three times from one set of dense trees: dense, int8
    (UNet and aux models) and fp8 (UNet), the quantized runs through the
    quantized-matmul kernel.  Returns the result lines."""
    import numpy as np

    trees = build_sdxl_trees()
    runs = (("dense", {}, 0),
            ("int8", {"weight_quant": "int8", "weight_quant_aux": "int8",
                      "quant_compute": "pallas"}, expected_quant),
            ("fp8", {"weight_quant": "fp8", "quant_compute": "pallas"}, expected_quant))
    results, dense_latent = [], None
    for label, quant, n_quant in runs:
        pipe, init_s = build_sdxl_pipeline(trees, **quant)
        t0 = time.perf_counter()  # a first call loads kernels and picks algorithms
        pipe(PROMPT, num_inference_steps=4, seed=0, output_type="np")
        warmup_s = time.perf_counter() - t0
        result, latent = pipeline_run(
            pipe, init_s, label, {"flash_sdpa": expected_flash, "quant_matmul": n_quant})
        result["warmup_call_s"] = warmup_s
        if dense_latent is None:
            dense_latent = latent
        else:  # information only: quantization moves the image
            result["latent_rel_l2_vs_dense"] = float(
                np.linalg.norm(latent - dense_latent) / np.linalg.norm(dense_latent))
        print(json.dumps(result), flush=True)
        results.append(result)
        del pipe
    return results


def _kernel_group(name: str) -> str:
    """Coarse family of a device kernel by its name (cuDNN convolution
    kernels are matched before GEMMs, which share the xmma/cutlass names)."""
    low = name.lower()
    if "flash_fwd_kernel" in low:
        return "attention (flash_sdpa)"
    if "qmm_kernel" in low:
        return "quantized matmul (quant_matmul)"
    if "conv" in low or "cudnn" in low or "implicit" in low:
        return "convolution"
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "gemm"
    if "norm" in low or "reduce" in low:
        return "reductions (norm moments, amax)"
    if "copy" in low or "cat" in low or "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise and other"


def profile_phase(out_dir, weight_quant):
    """The main path once warm, then once under torch.profiler: device time
    by kernel family, the device's busy and idle share of the wall time,
    and the top kernels (full table written to out_dir)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    quant = {}
    if weight_quant != "none":
        quant = {"weight_quant": weight_quant, "quant_compute": "pallas"}
    pipe, _ = build_sdxl_pipeline(build_sdxl_trees(), **quant)
    pipe(PROMPT, num_inference_steps=4, seed=0, output_type="np")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(PROMPT, num_inference_steps=4, seed=0, output_type="np")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    groups = {}
    for e in kernels:
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_sdxl_{weight_quant}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
    print(json.dumps({
        "phase": "profile", "weight_quant": weight_quant, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                         "calls": e.count} for e in top],
    }), flush=True)


def kernel_entry(rows, launches, **fields):
    """One entry of the kernels line: per-shape numbers weighted by each
    shape's launches in one pipeline call."""
    rows = [r for r in rows if r["launches_per_call"]]
    ops_ms = sum(r["bound_ms"] * r["launches_per_call"] for r in rows
                 if r["bound_by"] == "operations")
    bytes_ms = sum(r["bound_ms"] * r["launches_per_call"] for r in rows
                   if r["bound_by"] == "bytes")

    def per_call(key):
        vals = [r[key] for r in rows]
        if any(v is None for v in vals):
            return None
        return sum(v * r["launches_per_call"] for v, r in zip(vals, rows))

    extra = {}
    if all("device_ms" in r for r in rows):  # flash: device time under the profiler
        extra = {"device_ms": per_call("device_ms"),
                 "library_device_ms": per_call("library_device_ms")}
    return {
        **fields,
        **extra,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_call("ms"),
        "plain_ms": per_call("plain_ms"),
        "bound_ms": ops_ms + bytes_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": per_call("library_ms"),
    }


def build_kernels():
    """Build every kernel of the path, one nvcc per source, all started
    together; print each build's ptxas register and shared-memory report."""
    from concurrent.futures import ThreadPoolExecutor

    from distrifuser_tpu_torch.ops import flash_attention as fa
    from distrifuser_tpu_torch.ops import quant_matmul as qm

    def timed(build):
        t = time.perf_counter()
        return build(), time.perf_counter() - t

    sources = {"flash_attention.cu": fa.build, "quant_matmul.cu": qm.build}
    with ThreadPoolExecutor(len(sources)) as pool:
        done = dict(zip(sources, pool.map(timed, sources.values())))
    for name, (log, seconds) in done.items():
        print(f"built {name} in {seconds:.1f} s", flush=True)
        for line in log.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill")) or \
                    "error" in line.lower():
                print(f"  ptxas: {line.strip()}", flush=True)


def main(argv) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="only profile the warm main path (torch.profiler) "
                             "and print the device-time breakdown")
    parser.add_argument("--weight_quant", default="none", choices=("none", "int8", "fp8"),
                        help="with --profile: the path to profile (quantized "
                             "runs use quant_compute='pallas')")
    parser.add_argument("--out_dir", default="build/profile",
                        help="where --profile writes its full kernel table")
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
    build_kernels()

    set_precision_flags()
    if args.profile:
        profile_phase(args.out_dir, args.weight_quant)
        return 0
    ucfg, vcfg = unet.sdxl_config(), vae.sdxl_vae_config()
    steps = 4
    shapes = attention_shapes(ucfg, vcfg, 1024, 1024, unet_evals=steps)
    expected_flash = steps * unet.attention_calls_per_forward(ucfg) + 1
    assert sum(s[-1] for s in shapes) == expected_flash, (shapes, expected_flash)
    per_forward, per_call = unet.linear_calls(ucfg)
    expected_quant = steps * per_forward + per_call
    qshapes = quant_shapes(ucfg, 1024, 1024, steps)
    assert sum(s[-1] for s in qshapes) == expected_quant, (qshapes, expected_quant)

    rows = kernel_phase(shapes)
    qrows = quant_kernel_phase(qshapes)
    for weight_quant in ("none", "int8", "fp8"):
        tiny_check(weight_quant)
    runs = {r["run"]: r for r in pipeline_phase(expected_flash, expected_quant)}

    quant_fields = {
        "route": "cuda",
        "source": "distrifuser_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "distrifuser_tpu/ops/quant_matmul.py:54",
    }
    kernels = [
        kernel_entry(rows, runs["dense"]["flash_sdpa_launches"],
                     name="flash_sdpa", route="cuda",
                     source="distrifuser_tpu_torch/csrc/flash_attention.cu",
                     replaces="distrifuser_tpu/ops/flash_attention.py:41",
                     work="all attention of one 4-step 1024x1024 SDXL pipeline call "
                          "(per-shape time x launches per call)"),
        kernel_entry([r for r in qrows if r["mode"] == "int8"],
                     runs["int8"]["quant_matmul_launches"], name="quant_matmul",
                     **quant_fields,
                     work="all quantized linears of one 4-step 1024x1024 SDXL "
                          "pipeline call at weight_quant='int8' (per-shape time x "
                          "launches per call); 'fp8' holds the same for fp8",
                     fp8=kernel_entry([r for r in qrows if r["mode"] == "fp8"],
                                      runs["fp8"]["quant_matmul_launches"])),
    ]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
