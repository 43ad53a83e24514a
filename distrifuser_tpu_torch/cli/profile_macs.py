"""The UNet's cost at each resolution: counterpart of scripts/profile_macs.py.

One UNet forward of the preset (``--model sdxl``, ``sd15`` or ``tiny``),
counted by ``torch.utils.flop_counter.FlopCounterMode`` on fake tensors
(``FakeTensorMode``): the weights and activations have shapes and no
memory, nothing executes, and every op runs its plain version, so the
count is the same whichever kernel runs the work on the card.  It counts
the convolutions, GEMMs and the attention's two products (2 x
multiply-adds); the JAX script reads XLA's cost analysis, which counts
elementwise work too.  One line a resolution:

    python -m distrifuser_tpu_torch.cli.profile_macs --model sdxl --image_size 1024 2048
"""

from __future__ import annotations

import argparse

import torch


def unet_flops(model: str, size: int, batch_size: int, dtype: torch.dtype):
    """``(flops, weight bytes, parameters)`` of one forward of the preset
    ``model`` on ``batch_size`` latents of a ``size`` x ``size`` image."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..models import unet as unet_mod
    from ..models.weights import _leaves, params_nbytes

    ucfg = {"sdxl": unet_mod.sdxl_config, "sd15": unet_mod.sd15_config,
            "tiny": unet_mod.tiny_config}[model]()
    with FakeTensorMode():
        params = unet_mod.init_unet_params(torch.Generator().manual_seed(0), ucfg, dtype)
        h = w = size // 8
        sample = torch.zeros((batch_size, h, w, ucfg.in_channels), dtype=dtype)
        enc = torch.zeros((batch_size, 77, ucfg.cross_attention_dim), dtype=dtype)
        added = None
        if ucfg.addition_embed_type == "text_time":
            pooled = (ucfg.projection_class_embeddings_input_dim
                      - 6 * ucfg.addition_time_embed_dim)
            added = {"text_embeds": torch.zeros((batch_size, pooled), dtype=dtype),
                     "time_ids": torch.zeros((batch_size, 6))}
        with FlopCounterMode(display=False) as counter:
            unet_mod.unet_forward(params, ucfg, sample, torch.full((batch_size,), 500.0),
                                  enc, added_cond=added)
        n_params = sum(leaf.numel() for leaf in _leaves(params))
        return counter.get_total_flops(), params_nbytes(params), n_params


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", type=str, default="sdxl", choices=["sdxl", "sd15", "tiny"])
    parser.add_argument("--image_size", type=int, nargs="*", default=[1024])
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--dtype", type=str, default="bfloat16")
    args = parser.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    for size in args.image_size or [1024]:
        flops, nbytes, n_params = unet_flops(args.model, size, args.batch_size, dtype)
        print(f"{args.model} @ {size}x{size}: {flops / 1e9:.2f} GFLOPs "
              f"(~{flops / 2e9:.2f} GMACs), {nbytes / 1e9:.2f} GB of weights, "
              f"{n_params / 1e6:.1f}M params", flush=True)


if __name__ == "__main__":
    main()
