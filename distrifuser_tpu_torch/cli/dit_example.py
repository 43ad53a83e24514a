"""PixArt-α / DiT generation under displaced patch parallelism (counterpart
of scripts/dit_example.py).

With ``--model <snapshot dir>`` it loads a local PixArt snapshot
(transformer/, vae/, text_encoder/, tokenizer/) through
``DistriPixArtPipeline``, captures its graphs and writes a PNG.  Without it
the PixArt-α DiT runs with seeded random weights at its published widths
(``--depth`` cuts its blocks; ``--tiny_model`` the tiny test DiT at
128 x 128) on random caption states, and the denoised latent is saved as
``.npy``: a structure and latency run.

    python -m distrifuser_tpu_torch.cli.dit_example --device cpu --tiny_model \\
        --num_inference_steps 4
    python -m distrifuser_tpu_torch.cli.dit_example --model /path/to/PixArt-XL-2-1024-MS
    torchrun --nproc_per_node 4 -m distrifuser_tpu_torch.cli.dit_example --depth 4

``--parallelism`` takes "patch" (displaced, the default) or "pipefusion"
(the DiT's blocks as pipeline stages over the ranks, ``--pipe_patches``
token chunks streaming through them; it replays captured ticks, so it
refuses ``--no_cuda_graph``); ``--init_image`` is refused, as diffusers'
PixArt is text-to-image only.

    python -m distrifuser_tpu_torch.cli.dit_example --device cpu --tiny_model \
        --parallelism pipefusion --pipe_patches 4 --num_inference_steps 4
"""

import argparse
import dataclasses
import sys

import numpy as np
import torch

from .common import (add_distri_args, config_from_args, finish_distributed,
                     init_distributed, is_main_process)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    add_distri_args(parser)
    parser.add_argument("--depth", type=int, default=None,
                        help="override the DiT's depth (random weights)")
    parser.add_argument("--model", type=str, default=None,
                        help="local PixArt snapshot dir (transformer/, vae/, "
                        "text_encoder/, tokenizer/); omit for random weights")
    parser.set_defaults(prompt="an astronaut riding a horse on the moon")
    args = parser.parse_args(argv)
    if args.parallelism not in ("patch", "pipefusion"):
        parser.error(f"--parallelism {args.parallelism} is a UNet strategy; the DiT "
                     "supports 'patch' (displaced) or 'pipefusion'")
    if args.init_image is not None:
        parser.error("img2img is a UNet-pipeline feature (diffusers' PixArt is "
                     "text2img-only); --init_image is not supported here")
    if args.tiny_model:
        args.image_size = [128, 128]  # the tiny DiT's 16 x 16 latent
    init_distributed(args.device)
    try:
        cfg = config_from_args(args, parser.error)
        if args.model:
            _run_pipeline(args, cfg, parser.error)
        else:
            _run_random(args, cfg, parser.error)
    finally:
        finish_distributed()
    return 0


def _run_pipeline(args, cfg, error) -> None:
    from ..pipelines import DistriPixArtPipeline

    try:
        pipe = DistriPixArtPipeline.from_pretrained(cfg, args.model,
                                                    scheduler=args.scheduler)
    except (ValueError, NotImplementedError) as e:
        error(str(e))
    pipe.prepare(num_inference_steps=args.num_inference_steps)
    out = pipe(prompt=args.prompt, num_inference_steps=args.num_inference_steps,
               guidance_scale=args.guidance_scale, seed=args.seed)
    if is_main_process():
        out.images[0].save(args.output_path)
        print(f"image -> {args.output_path}")
    del pipe  # graphs holding NCCL work go before the process group


def _run_random(args, cfg, error) -> None:
    from ..models import dit as dit_mod
    from ..parallel.dit_sp import DiTDenoiseRunner
    from ..parallel.pipefusion import PipeFusionRunner
    from ..schedulers import get_scheduler

    if args.tiny_model:
        dcfg = dit_mod.tiny_dit_config(depth=args.depth or 2 * cfg.n_device_per_batch)
    else:
        base = dit_mod.pixart_config()
        dcfg = dataclasses.replace(base, sample_size=cfg.latent_height,
                                   depth=args.depth or base.depth)
    gen = torch.Generator(device=cfg.device).manual_seed(args.seed)
    params = dit_mod.init_dit_params(gen, dcfg, cfg.dtype)
    try:
        runner_cls = PipeFusionRunner if cfg.parallelism == "pipefusion" else DiTDenoiseRunner
        runner = runner_cls(cfg, dcfg, params, get_scheduler(args.scheduler))
    except (ValueError, NotImplementedError) as e:
        error(str(e))
    cpu = torch.Generator().manual_seed(args.seed)
    lat = torch.randn(args.batch_size, dcfg.sample_size, dcfg.sample_size,
                      dcfg.in_channels, generator=cpu)
    # random "prompt" conditioning: with real weights the T5 states per branch
    enc = torch.randn(2, args.batch_size, 77, dcfg.caption_dim, generator=cpu)
    out = runner.generate(lat, enc.to(cfg.dtype),
                          guidance_scale=args.guidance_scale,
                          num_inference_steps=args.num_inference_steps)
    out = out.cpu().numpy()
    if is_main_process():
        path = args.output_path.replace(".png", ".npy")
        np.save(path, out)
        print(f"denoised latent {out.shape} -> {path} "
              f"(std {out.std():.3f}, finite={bool(np.isfinite(out).all())})")
    del runner


if __name__ == "__main__":
    sys.exit(main())
