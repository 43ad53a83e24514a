#!/usr/bin/env python3
"""Drive the PyTorch / H100 port on one CUDA card and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. print the card's name and power limit (nvidia-smi) and build every
   kernel of the path from this checkout's sources (nvcc, sm_90a);
2. kernel phase: at every shape SDXL 1024x1024 gives the flash-attention
   kernel (derived from the UNet and VAE configs), hold the kernel against
   its plain PyTorch version on seeded bf16 inputs (max |d| <= 2e-2, mean
   |d| <= 2e-3: a few bf16 roundings of outputs below 1) and time the
   kernel, the plain version and F.scaled_dot_product_attention (a
   yardstick only; the port never calls it) with CUDA events;
3. small-input check: the tiny SDXL pipeline in bf16 on the card against
   the same pipeline in float32 on the CPU (plain attention), same weights
   and latents, relative L2 of the latents <= 8e-2 (2.3e-2 measured for bf16 vs float32 on a CPU);
4. main path: DistriSDXLPipeline at full SDXL width (UNet, ViT-L + bigG
   text encoders, SDXL VAE; seeded random bf16 weights), one prompt,
   4 DDIM steps at 1024x1024 -> a finite (1024, 1024, 3) image, with the
   kernel's launch count read around exactly this call (4*140 + 1).

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
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
KERNEL_MAX_ABS, KERNEL_MEAN_ABS = 2e-2, 2e-3
TINY_REL_L2 = 8e-2
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
        ms = time_ms(lambda: fa.flash_sdpa(q, k, v, heads=heads))
        plain_ms = time_ms(lambda: fa.flash_sdpa_reference(q, k, v, heads=heads),
                           max_iters=10)
        qh, kh, vh = (t.unflatten(-1, (heads, d)).transpose(1, 2) for t in (q, k, v))
        try:
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        except RuntimeError as e:  # no library kernel for this shape
            print(f"library sdpa unavailable at {name}: {e}", file=sys.stderr)
            library_ms = None
        flops = 4.0 * b * heads * lq * lk * d
        nbytes = 2.0 * (2 * b * lq * c + 2 * b * lk * c)  # q, o; k, v
        ops_ms, bytes_ms = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = {
            "shape": name, "B": b, "Lq": lq, "Lk": lk, "H": heads, "d": d,
            "launches_per_call": calls, "max_abs_err": max_err,
            "mean_abs_err": mean_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "tflops": flops / (ms * 1e-3) / 1e12,
        }
        print(json.dumps(row), flush=True)
        results.append(row)
        del q, k, v, got, want, err
        torch.cuda.empty_cache()
    return results


def tiny_check():
    """Tiny SDXL pipeline: bf16 on the card (kernel) vs float32 on the CPU
    (plain attention), same weights and latents."""
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
    outs = []
    for device, dtype in CHECK_DEVICES:
        dtype = getattr(torch, dtype)
        u, v = (cast_params(t, dtype, device) for t in trees[:2])
        ts = [cast_params(t, dtype, device) for t in trees[2]]
        cfg = DistriConfig(device=device, height=128, width=128)
        pipe = DistriSDXLPipeline.from_params(cfg, ucfg, u, vcfg, v, tcfgs, ts)
        outs.append(pipe("a lighthouse at dusk", num_inference_steps=3,
                         latents=latents, output_type="latent").images[0])
    ref, got = outs
    if not np.isfinite(got).all():
        raise AssertionError("tiny pipeline on the card gave non-finite latents")
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    result = {"phase": "tiny_check", "rel_l2": rel,
              "max_abs": float(np.abs(got - ref).max()), "limit_rel_l2": TINY_REL_L2}
    print(json.dumps(result), flush=True)
    if rel > TINY_REL_L2:
        raise AssertionError(f"tiny pipeline bf16/card vs fp32/cpu rel L2 {rel}")


def build_sdxl_pipeline():
    """Full-width SDXL pipeline on the first card, seeded random bf16
    weights; returns (pipeline, seconds to build)."""
    import torch

    from distrifuser_tpu_torch import DistriConfig, DistriSDXLPipeline
    from distrifuser_tpu_torch.models import clip, unet, vae

    t_init = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ucfg, vcfg = unet.sdxl_config(), vae.sdxl_vae_config()
    tcfgs = [clip.clip_vit_l_config(), clip.open_clip_bigg_config()]
    cfg = DistriConfig(height=1024, width=1024)  # first CUDA card, bf16
    pipe = DistriSDXLPipeline.from_params(
        cfg, ucfg, unet.init_unet_params(gen, ucfg, cfg.dtype), vcfg,
        vae.init_vae_params(gen, vcfg, cfg.dtype), tcfgs,
        [clip.init_clip_params(gen, tc, cfg.dtype) for tc in tcfgs],
    )
    torch.cuda.synchronize()
    return pipe, time.perf_counter() - t_init


def pipeline_phase(expected_launches):
    import numpy as np
    import torch

    from distrifuser_tpu_torch.ops import flash_attention as fa

    pipe, init_s = build_sdxl_pipeline()
    marks = []

    def on_step(i, t, x):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    fa.flash_sdpa.launches = 0
    t0 = time.perf_counter()
    out = pipe(PROMPT, num_inference_steps=4, seed=0, output_type="np",
               callback=on_step)
    total_s = time.perf_counter() - t0
    launches = fa.flash_sdpa.launches
    img = out.images[0]
    if img.shape != (1024, 1024, 3) or not np.isfinite(img).all():
        raise AssertionError(f"image shape {img.shape}, finite {np.isfinite(img).all()}")
    pixels = (img * 255).round().astype(np.uint8)
    if launches != expected_launches:
        raise AssertionError(f"flash_sdpa launched {launches} times, expected "
                             f"{expected_launches}")
    steps = [(marks[i] - marks[i - 1]) * 1e3 for i in range(1, len(marks))]
    result = {
        "phase": "pipeline", "model": "SDXL-base widths, random bf16 weights",
        "height": 1024, "width": 1024, "steps": 4, "prompts": 1,
        "init_s": init_s, "total_s": total_s,
        "first_step_ms_incl_text_encode": (marks[0] - t0) * 1e3,
        "step_ms": steps, "decode_and_copy_ms": (t0 + total_s - marks[-1]) * 1e3,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "flash_sdpa_launches": launches, "pixel_mean": float(pixels.mean()),
    }
    print(json.dumps(result), flush=True)
    return launches


def _kernel_group(name: str) -> str:
    """Coarse family of a device kernel by its name (cuDNN convolution
    kernels are matched before GEMMs, which share the xmma/cutlass names)."""
    low = name.lower()
    if "flash_fwd_kernel" in low:
        return "attention (flash_sdpa)"
    if "conv" in low or "cudnn" in low or "implicit" in low:
        return "convolution"
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "gemm"
    if "norm" in low or "reduce" in low:
        return "reductions (norm moments)"
    if "copy" in low or "cat" in low or "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise and other"


def profile_phase(out_dir):
    """The main path once warm, then once under torch.profiler: device time
    by kernel family, the device's busy and idle share of the wall time,
    and the top kernels (full table written to out_dir)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    pipe, _ = build_sdxl_pipeline()
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
    with open(os.path.join(out_dir, "profile_sdxl.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
    print(json.dumps({
        "phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                         "calls": e.count} for e in top],
    }), flush=True)


def main(argv) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="only profile the warm main path (torch.profiler) "
                             "and print the device-time breakdown")
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
        from distrifuser_tpu_torch.ops import flash_attention as fa
        from distrifuser_tpu_torch.utils.env import set_precision_flags
    except ImportError as e:
        print(f"chip_smoke: the distrifuser_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t = time.perf_counter()
    log = fa.build()
    print(f"built flash_attention.cu in {time.perf_counter() - t:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"  ptxas: {line.strip()}", flush=True)

    set_precision_flags()
    if args.profile:
        profile_phase(args.out_dir)
        return 0
    ucfg, vcfg = unet.sdxl_config(), vae.sdxl_vae_config()
    steps = 4
    shapes = attention_shapes(ucfg, vcfg, 1024, 1024, unet_evals=steps)
    expected = steps * unet.attention_calls_per_forward(ucfg) + 1
    assert sum(s[-1] for s in shapes) == expected, (shapes, expected)
    rows = kernel_phase(shapes)
    tiny_check()
    launches = pipeline_phase(expected)

    ops_ms = sum(r["bound_ms"] * r["launches_per_call"] for r in rows
                 if r["bound_by"] == "operations")
    bytes_ms = sum(r["bound_ms"] * r["launches_per_call"] for r in rows
                   if r["bound_by"] == "bytes")

    def per_call(key):
        vals = [r[key] for r in rows]
        if any(v is None for v in vals):
            return None
        return sum(v * r["launches_per_call"] for v, r in zip(vals, rows))

    kernels = [{
        "name": "flash_sdpa",
        "route": "cuda",
        "source": "distrifuser_tpu_torch/csrc/flash_attention.cu",
        "replaces": "distrifuser_tpu/ops/flash_attention.py:41",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_call("ms"),
        "plain_ms": per_call("plain_ms"),
        "bound_ms": ops_ms + bytes_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": per_call("library_ms"),
        "work": "all attention of one 4-step 1024x1024 SDXL pipeline call "
                "(per-shape time x launches per call)",
    }]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
