"""What the port's command-line scripts share: the flag surface, the config
built from it, the pipeline loaders, img2img input and image output.

Counterpart of scripts/common.py (``add_distri_args``, ``config_from_args``,
``img2img_kwargs``, ``save_images``, ``load_sdxl_pipeline``,
``load_sd_pipeline``, ``load_sd3_pipeline``, ``FAMILY_DEFAULTS``,
``check_family_scheduler``, ``is_main_process``), with one
flag more, ``--device`` (default: this rank's CUDA card; ``cpu`` runs the
plain path).  Every other flag does what the JAX script's flag does or is
refused, before any model loads, with the ROADMAP item that brings it:

* the comm knobs (``--attn_impl`` ring, ulysses or usp with
  ``--ulysses_degree``, ``--comm_batch``, ``--comm_compress``,
  ``--refresh_fraction``) pass through to ``DistriConfig``, which
  validates them as the JAX package does, and the runners refuse what the
  JAX runners refuse (ulysses and usp outside the DiT); ``--dp_degree``
  too; a float32 ``--dtype`` on the card goes through ``DistriConfig``'s
  own refusal, ``--parallelism pipefusion`` (the DiT's) through the UNet
  and MMDiT runners', a
  sampler of the other family (``--scheduler flow-euler`` on the UNet,
  anything else on SD3) through ``check_family_scheduler`` and the
  pipelines' own check;
* ``--pipe_patches`` sets PipeFusion's token chunks (``--parallelism
  pipefusion``, cli/dit_example.py) and, as in the JAX scripts, is refused
  by ``DistriConfig`` under any other parallelism;
* ``--hybrid_loop`` has nothing to change: the port's loop is always the
  host's, one UNet graph per phase, which is what the flag picks in the
  JAX package (same numerics).

Several ranks run under ``torchrun``: ``init_distributed`` joins the
process group it describes (gloo on the CPU or for ranks that share a
card, NCCL for the cards' tensors where every rank has its own).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

# per-family protocol defaults: SD runs the reference's sd_example point,
# SD3 its published flow-euler / guidance 7 / 28-step point
FAMILY_DEFAULTS = {
    "sdxl": {},
    "sd": {"image_size": [512, 512], "guidance_scale": 7.5, "sync_mode": "stale_gn"},
    "sd3": {"scheduler": "flow-euler", "guidance_scale": 7.0, "num_inference_steps": 28},
}

WEIGHTLESS_WARNING = (
    "generated with the hash-based SimpleTokenizer fallback (no CLIP vocab files "
    "were loadable): latency characteristics are valid, image content is NOT "
    "comparable to real-prompt outputs")


def add_distri_args(parser: argparse.ArgumentParser) -> None:
    """The JAX scripts' flag surface (the reference's run_sdxl.py flags and
    their extensions) plus ``--device``."""
    parser.add_argument("--model_path", type=str, default=None,
                        help="local diffusers snapshot dir (unet/, vae/, text_encoder*/)")
    parser.add_argument("--random_weights", action="store_true",
                        help="run with seeded random weights at the published widths")
    parser.add_argument("--tiny_model", action="store_true",
                        help="with --random_weights: the tiny test architecture "
                        "(CPU-scale smoke runs)")
    parser.add_argument("--prompt", type=str,
                        default="Astronaut in a jungle, cold color palette, "
                        "muted colors, detailed, 8k")
    parser.add_argument("--output_path", type=str, default="output.png")
    parser.add_argument("--num_inference_steps", type=int, default=50)
    parser.add_argument("--image_size", type=int, nargs="*", default=[1024, 1024])
    parser.add_argument("--guidance_scale", type=float, default=5.0)
    parser.add_argument("--scheduler", type=str, default="ddim",
                        choices=["ddim", "euler", "dpm-solver", "flow-euler"],
                        help="flow-euler is the SD3 family's rectified-flow sampler, "
                        "and the only one it takes")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--no_split_batch", action="store_true",
                        help="disable CFG batch splitting")
    parser.add_argument("--warmup_steps", type=int, default=4)
    parser.add_argument("--sync_mode", type=str, default="corrected_async_gn",
                        choices=["separate_gn", "stale_gn", "corrected_async_gn",
                                 "sync_gn", "full_sync", "no_sync"])
    parser.add_argument("--parallelism", type=str, default="patch",
                        choices=["patch", "tensor", "naive_patch", "pipefusion"],
                        help="pipefusion is a DiT strategy (refused for the UNet)")
    parser.add_argument("--pipe_patches", type=int, default=None,
                        help="with --parallelism pipefusion: token chunks streaming "
                        "through the pipeline stages (default: one a stage)")
    parser.add_argument("--no_cuda_graph", action="store_true",
                        help="run the UNet eagerly instead of replaying its CUDA graphs")
    parser.add_argument("--split_scheme", type=str, default="row",
                        choices=["row", "col", "alternate"])
    parser.add_argument("--output_type", type=str, default="pil",
                        choices=["latent", "pil"])
    parser.add_argument("--batch_size", type=int, default=1,
                        help="images per UNet batch (longer lists run in chunks)")
    parser.add_argument("--dp_degree", type=int, default=1,
                        help="data-parallel image groups: each runs its share of "
                        "the batch on world / dp_degree ranks")
    parser.add_argument("--attn_impl", type=str, default="gather",
                        choices=["gather", "ring", "ulysses", "usp"],
                        help="patch attention layout (ring: each rank holds its own "
                        "KV chunk and the peers' stream around; ulysses and usp: the "
                        "DiT's exact head-sharded layouts)")
    parser.add_argument("--ulysses_degree", type=int, default=1,
                        help="with --attn_impl usp: factor the patch group into "
                        "ulysses_degree (head-sharding all-to-all) x ring")
    parser.add_argument("--comm_batch", action="store_true",
                        help="exchange every stale refresh of a step in one flat "
                        "all-gather per dtype and one flat halo pair")
    parser.add_argument("--comm_compress", type=str, default="none",
                        choices=["none", "int8", "fp8", "int8_residual"],
                        help="quantize the stale-refresh halo and KV payloads on the "
                        "wire (int8/fp8 with a float32 scale per row; int8_residual "
                        "codes the delta against the previous value)")
    parser.add_argument("--refresh_fraction", type=float, default=1.0,
                        help="PCPP partial refresh: each stale step refreshes this "
                        "fraction (1/k) of every KV slab and conv halo, rotating the "
                        "strided row group by step; 1.0 is the exact protocol")
    parser.add_argument("--weight_quant", type=str, default="none",
                        choices=["none", "int8", "fp8"],
                        help="hold the UNet's matmul and conv kernels as int8/fp8 "
                        "payloads with per-channel scales (quant_compute 'auto', as "
                        "in the JAX scripts)")
    parser.add_argument("--weight_quant_aux", type=str, default="none",
                        choices=["none", "int8", "fp8"],
                        help="the same for the text encoders and the VAE")
    parser.add_argument("--no_vae_sp", action="store_true",
                        help="disable the sequence-parallel VAE decode (with the "
                        "image in patches, decode whole, or in row tiles above 1024 "
                        "px, on every rank instead: the same image)")
    parser.add_argument("--dtype", type=str, default=None,
                        choices=["bfloat16", "float32"],
                        help="compute dtype (default: bf16 on the card, float32 on "
                        "the CPU; the card's kernels are bf16 only)")
    parser.add_argument("--hybrid_loop", action="store_true",
                        help="the JAX package's per-step warm-up loop; the port's "
                        "loop always runs step by step (no effect)")
    parser.add_argument("--num_images_per_prompt", type=int, default=1)
    parser.add_argument("--init_image", type=str, default=None,
                        help="img2img: path to the init image (png/jpg), sized to "
                        "the configured height x width")
    parser.add_argument("--strength", type=float, default=0.8,
                        help="img2img noise strength (with --init_image)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda, cuda:N or cpu (default: the CUDA card of this "
                        "rank's LOCAL_RANK)")


def init_distributed(device) -> None:
    """Join the process group torchrun describes (``WORLD_SIZE`` > 1): gloo
    on the CPU or where ranks outnumber the cards, else gloo for CPU
    tensors and NCCL for the cards'."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 or dist.is_initialized():
        return
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if on_cpu or torch.cuda.device_count() < world:
        backend = "gloo"
    else:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "cpu:gloo,cuda:nccl"
    dist.init_process_group(backend)


def finish_distributed() -> None:
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def image_size(args):
    size = args.image_size
    if isinstance(size, int):
        return size, size
    if len(size) == 1:
        return size[0], size[0]
    return tuple(size)


def config_from_args(args, error):
    """The run's ``DistriConfig``; ``error(message)`` (``parser.error``)
    refuses a flag the port does not run."""
    from ..utils.config import DistriConfig

    h, w = image_size(args)
    try:
        return DistriConfig(
            height=h, width=w,
            # guidance_scale <= 1 disables CFG entirely, as in the reference
            do_classifier_free_guidance=args.guidance_scale > 1,
            split_batch=not args.no_split_batch, warmup_steps=args.warmup_steps,
            mode=args.sync_mode, use_cuda_graph=not args.no_cuda_graph,
            parallelism=args.parallelism, split_scheme=args.split_scheme,
            pipe_patches=args.pipe_patches, batch_size=args.batch_size, dp_degree=args.dp_degree,
            attn_impl=args.attn_impl, ulysses_degree=args.ulysses_degree,
            comm_batch=args.comm_batch,
            comm_compress=args.comm_compress, refresh_fraction=args.refresh_fraction,
            weight_quant=args.weight_quant, weight_quant_aux=args.weight_quant_aux,
            vae_sp=not args.no_vae_sp, device=args.device,
            dtype=None if args.dtype is None else getattr(torch, args.dtype))
    except (ValueError, NotImplementedError) as e:
        error(str(e))


def img2img_kwargs(args) -> dict:
    """``--init_image`` / ``--strength`` as the pipeline's img2img keywords
    ({} without an image), the image read before any model loads."""
    if args.init_image is None:
        return {}
    from PIL import Image

    return {"image": np.asarray(Image.open(args.init_image).convert("RGB")),
            "strength": args.strength}


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def save_images(output, args) -> None:
    """Save the PIL images on rank 0 (several get an ``_i`` suffix); a run
    with the hash tokenizer leaves a warning file beside them."""
    if not is_main_process() or args.output_type != "pil":
        return
    root, ext = os.path.splitext(args.output_path)
    for i, im in enumerate(output.images):
        path = args.output_path if len(output.images) == 1 else f"{root}_{i}{ext}"
        im.save(path)
        print(f"saved {path}")
    if output.weightless_tokenizer:
        warn_path = f"{root}.WEIGHTLESS_TOKENIZER.txt"
        with open(warn_path, "w") as f:
            f.write(WEIGHTLESS_WARNING + "\n")
        print(f"WARNING: {WEIGHTLESS_WARNING} (marker: {warn_path})")


def check_family_scheduler(family: str, scheduler: str, error) -> None:
    """Refuse a sampler that does not fit the family before any model
    loads (the pipelines check too): SD3 takes flow-euler only."""
    if family == "sd3" and scheduler != "flow-euler":
        error("SD3 is a rectified-flow model: only --scheduler flow-euler applies")


def load_sd3_pipeline(args, cfg, error):
    """The SD3 pipeline from ``--model_path`` or, with ``--random_weights``,
    seeded random trees on the config's device: the tiny test stack, or
    SD3-medium's widths (the MMDiT at the config's latent size, CLIP-L with
    its 768 projection, bigG, the SD3 VAE; no T5, as the JAX script's)."""
    import dataclasses

    from ..models import clip, mmdit, vae
    from ..pipelines import DistriSD3Pipeline

    try:
        if args.model_path:
            return DistriSD3Pipeline.from_pretrained(cfg, args.model_path,
                                                     scheduler=args.scheduler)
        if not args.random_weights:
            error("pass --model_path <local diffusers snapshot> or --random_weights")
        if args.tiny_model:
            mcfg, vcfg = mmdit.tiny_mmdit_config(), vae.tiny_vae_config()
            tcfgs = [clip.tiny_clip_config(hidden=16),
                     clip.CLIPTextConfig(vocab_size=1000, hidden_size=16,
                                         num_hidden_layers=2, num_attention_heads=4,
                                         intermediate_size=32, projection_dim=8)]
        else:
            mcfg, vcfg = mmdit.sd3_config(cfg.latent_height), vae.sd3_vae_config()
            tcfgs = [dataclasses.replace(clip.clip_vit_l_config(), projection_dim=768),
                     clip.open_clip_bigg_config()]
        gen = torch.Generator(device=cfg.device).manual_seed(0)
        return DistriSD3Pipeline.from_params(
            cfg, mcfg, mmdit.init_mmdit_params(gen, mcfg, cfg.dtype), vcfg,
            vae.init_vae_params(gen, vcfg, cfg.dtype), tcfgs,
            [clip.init_clip_params(gen, tc, cfg.dtype) for tc in tcfgs],
            scheduler=args.scheduler)
    except (ValueError, NotImplementedError) as e:
        error(str(e))


def _configs(family: str, tiny: bool):
    """(UNet, VAE, text encoder configs) of a family's random-weight run."""
    from ..models import clip, unet, vae

    if family == "sdxl":
        if tiny:
            return (unet.tiny_config(sdxl=True), vae.tiny_vae_config(),
                    [clip.tiny_clip_config(hidden=16),
                     clip.CLIPTextConfig(vocab_size=1000, hidden_size=16,
                                         num_hidden_layers=2, num_attention_heads=4,
                                         intermediate_size=32, projection_dim=32)])
        return (unet.sdxl_config(), vae.sdxl_vae_config(),
                [clip.clip_vit_l_config(), clip.open_clip_bigg_config()])
    if tiny:
        return unet.tiny_config(), vae.tiny_vae_config(), [clip.tiny_clip_config(hidden=32)]
    return unet.sd15_config(), vae.sd_vae_config(), [clip.clip_vit_l_config()]


def load_pipeline(family: str, args, cfg, error):
    """The family's pipeline ("sdxl", "sd" or "sd3") from ``--model_path``
    or, with ``--random_weights``, seeded random trees on the config's
    device."""
    from ..models import clip, unet, vae
    from ..pipelines import DistriSDPipeline, DistriSDXLPipeline
    from ..schedulers import get_scheduler

    if family == "sd3":
        return load_sd3_pipeline(args, cfg, error)
    cls = DistriSDXLPipeline if family == "sdxl" else DistriSDPipeline
    try:
        get_scheduler(args.scheduler)
        if args.model_path:
            return cls.from_pretrained(cfg, args.model_path, scheduler=args.scheduler)
        if not args.random_weights:
            error("pass --model_path <local diffusers snapshot> or --random_weights")
        ucfg, vcfg, tcfgs = _configs(family, args.tiny_model)
        gen = torch.Generator(device=cfg.device).manual_seed(0)
        return cls.from_params(
            cfg, ucfg, unet.init_unet_params(gen, ucfg, cfg.dtype), vcfg,
            vae.init_vae_params(gen, vcfg, cfg.dtype), tcfgs,
            [clip.init_clip_params(gen, tc, cfg.dtype) for tc in tcfgs],
            scheduler=args.scheduler)
    except (ValueError, NotImplementedError) as e:
        error(str(e))


def generation_kwargs(args, i2i) -> dict:
    """The pipeline call of one generation (the seed apart)."""
    return dict(prompt=args.prompt, num_inference_steps=args.num_inference_steps,
                guidance_scale=args.guidance_scale, output_type=args.output_type,
                num_images_per_prompt=args.num_images_per_prompt, **i2i)


def family_parser(family: str, **defaults) -> argparse.ArgumentParser:
    """The example scripts' flags with ``family``'s defaults (and
    ``defaults``)."""
    parser = argparse.ArgumentParser()
    add_distri_args(parser)
    parser.set_defaults(**FAMILY_DEFAULTS[family], **defaults)
    return parser


def run_example(family: str, argv=None, parser=None) -> int:
    """One generation of ``family`` from the command line, saved on rank 0
    (the example scripts); ``parser`` defaults to ``family_parser``."""
    parser = parser or family_parser(family)
    args = parser.parse_args(argv)
    check_family_scheduler(family, args.scheduler, parser.error)
    i2i = img2img_kwargs(args)  # a bad path fails before the model loads
    init_distributed(args.device)
    try:
        cfg = config_from_args(args, parser.error)
        pipeline = load_pipeline(family, args, cfg, parser.error)
        save_images(pipeline(seed=args.seed, **generation_kwargs(args, i2i)), args)
        del pipeline  # graphs holding NCCL work go before the process group
    finally:
        finish_distributed()
    return 0
