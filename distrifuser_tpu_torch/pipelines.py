"""User-facing SDXL text-to-image pipeline, single device.

Counterpart of distrifuser_tpu/pipelines.py (``SimpleTokenizer``,
``_tokenize``, ``PipelineOutput``, ``_normalize_prompts``,
``_batched_generate``, ``_DistriPipelineBase.__call__`` and
``DistriSDXLPipeline.from_params`` / ``_encode``).  ``from_params`` builds
a pipeline from in-memory parameter trees: the port's own random init
(models/*.init_*_params) or JAX trees through
``models.weights.params_from_jax``.  Initial noise comes from a
``torch.Generator`` seeded with ``seed`` (its numbers differ from JAX's);
callers that need identical noise pass ``latents``.  ``from_pretrained``,
img2img and ``DistriSDPipeline`` are ROADMAP queue 1 items 5 and 6.

Weight quantization happens at load time, as in the JAX package's
constructor: the UNet under ``DistriConfig.weight_quant`` with the
execution policy ``quant_compute`` (``"pallas"`` sends every quantized
linear through the CUDA kernel of ops/quant_matmul.py), the text encoders
and the VAE under ``weight_quant_aux`` (``_quantize_aux``), which always
densify at the consumer.  ``set_weight_quant``, ``set_quant_compute`` and
``weight_report`` are the counterparts of the JAX pipeline's hooks.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, List

import numpy as np
import torch

from .models import clip as clip_mod
from .models import vae as vae_mod
from .models.weights import params_nbytes, quantize_params, set_quant_compute
from .parallel.compress import validate_quant_compute, validate_weight_mode
from .parallel.runner import make_runner
from .schedulers import BaseScheduler, get_scheduler
from .utils.config import DistriConfig


class SimpleTokenizer:
    """Deterministic hash tokenizer for runs without CLIP vocab files: BOS,
    one crc32-hashed id per lower-cased word, EOS, EOS padding."""

    model_max_length = 77

    def __init__(self, vocab_size: int = 49408, eos: int = 49407, bos: int = 49406):
        self.vocab_size = vocab_size
        self.eos = eos
        self.bos = bos

    def __call__(self, texts: List[str], max_length: int = 77):
        ids = np.full((len(texts), max_length), self.eos, np.int64)
        for i, t in enumerate(texts):
            toks = [self.bos] + [
                zlib.crc32(w.encode()) % (self.vocab_size - 2)
                for w in t.lower().split()
            ][: max_length - 2]
            toks.append(self.eos)
            ids[i, : len(toks)] = toks
        return ids


def _tokenize(tok, texts: List[str]) -> np.ndarray:
    if isinstance(tok, SimpleTokenizer):
        return tok(texts)
    out = tok(texts, padding="max_length", max_length=tok.model_max_length,
              truncation=True, return_tensors="np")
    return np.asarray(out["input_ids"])


@dataclasses.dataclass
class PipelineOutput:
    images: List[Any]
    # set when a tokenizer is the hash-based SimpleTokenizer: image content
    # is then not comparable to real-prompt outputs
    weightless_tokenizer: bool = False


def _normalize_prompts(prompt, negative_prompt):
    """(prompts, negs) lists from the str-or-list call surface."""
    prompts = [prompt] if isinstance(prompt, str) else list(prompt)
    negs = (
        [negative_prompt] * len(prompts)
        if isinstance(negative_prompt, str)
        else list(negative_prompt)
    )
    if len(negs) != len(prompts):
        raise ValueError(f"{len(prompts)} prompts but {len(negs)} negative prompts")
    return prompts, negs


def _batched_generate(cfg, scheduler, prompts, negs, num_images_per_prompt,
                      seed, latents, in_channels, run_chunk):
    """Any number of prompts over the fixed ``cfg.batch_size``: each prompt
    repeated ``num_images_per_prompt`` times, the list run in batch_size
    chunks with the tail padded by its last entry (padded outputs dropped).
    Noise is drawn once for the whole expanded batch."""
    if not prompts or num_images_per_prompt < 1:
        raise ValueError("need at least one prompt and one image per prompt")
    prompts = [p for p in prompts for _ in range(num_images_per_prompt)]
    negs = [n for n in negs for _ in range(num_images_per_prompt)]
    total = len(prompts)
    bs = cfg.batch_size
    lat_shape = (total, cfg.latent_height, cfg.latent_width, in_channels)
    if latents is None:
        gen = torch.Generator().manual_seed(seed)
        latents = torch.randn(lat_shape, generator=gen) * scheduler.init_noise_sigma
    else:
        latents = torch.as_tensor(np.asarray(latents, np.float32))
        if tuple(latents.shape) != lat_shape:
            raise ValueError(f"latents of shape {tuple(latents.shape)}, "
                             f"expected {lat_shape}")
    latents = latents.to(cfg.device)
    outs = []
    for i in range(0, total, bs):
        stop = min(i + bs, total)
        pad = bs - (stop - i)
        cp, cn, cl = prompts[i:stop], negs[i:stop], latents[i:stop]
        if pad:
            cp = cp + [cp[-1]] * pad
            cn = cn + [cn[-1]] * pad
            cl = torch.cat([cl, cl[-1:].expand(pad, *cl.shape[1:])])
        out = run_chunk(cp, cn, cl)
        outs.append(out[:bs - pad])
    return torch.cat(outs, dim=0)


def _quantize_aux(cfg, vae_params, text_encoders):
    """Load-time quantization of the auxiliary models (VAE, CLIP text
    encoders) under ``weight_quant_aux``, with the "dequant" policy:
    returns ``(vae_params, [(config, params), ...])``."""
    q = lambda p: quantize_params(p, cfg.weight_quant_aux)  # noqa: E731
    return q(vae_params), [(tc, q(tp)) for tc, tp in text_encoders]


class DistriSDXLPipeline:
    """SDXL: two text encoders' penultimate hidden states concatenated,
    pooled embeds of the second, and the 6 micro-conditioning time ids.
    ``__call__`` is the counterpart of the JAX ``_DistriPipelineBase``'s."""

    def __init__(self, distri_config: DistriConfig, unet_config, unet_params,
                 vae_config, vae_params, scheduler: BaseScheduler, tokenizers,
                 text_encoders):
        self.distri_config = distri_config
        self.unet_config = unet_config
        self.vae_config = vae_config
        unet_params = quantize_params(unet_params, distri_config.weight_quant,
                                      compute=distri_config.quant_compute)
        # text_encoders: list of (CLIPTextConfig, params)
        self.vae_params, self.text_encoders = _quantize_aux(
            distri_config, vae_params, text_encoders)
        self.scheduler = scheduler
        self.tokenizers = tokenizers
        self.runner = make_runner(distri_config, unet_config, unet_params, scheduler)

    def set_weight_quant(self, mode: str) -> None:
        """Quantize the UNet's weights to ``mode`` after construction.  Only
        the direction from "none" exists: a quantized tree's full-precision
        values are gone, so a switch away from it raises; rebuild from the
        dense weights instead."""
        cfg = self.distri_config
        validate_weight_mode(mode)
        if mode == cfg.weight_quant:
            return
        if cfg.weight_quant != "none":
            raise ValueError(
                f"cannot switch weight_quant {cfg.weight_quant!r} -> {mode!r}: "
                "the full-precision kernels are gone; rebuild the pipeline "
                "from the dense weights instead")
        self.runner.params = quantize_params(self.runner.params, mode,
                                             compute=cfg.quant_compute)
        cfg.weight_quant = mode

    def set_quant_compute(self, policy: str) -> None:
        """Re-tag the UNet's quantized kernels with an execution policy
        (DistriConfig.quant_compute); payloads and scales are untouched."""
        cfg = self.distri_config
        validate_quant_compute(policy, cfg.weight_quant)
        if policy == cfg.quant_compute:
            return
        self.runner.params = set_quant_compute(self.runner.params, policy)
        cfg.quant_compute = policy

    def weight_report(self) -> dict:
        """Device bytes of each component's weights (a quantized kernel
        counts payload and scales) and the active modes."""
        cfg = self.distri_config
        parts = {
            "denoiser": params_nbytes(self.runner.params),
            "vae": params_nbytes(self.vae_params),
            "text_encoders": sum(params_nbytes(tp) for _, tp in self.text_encoders),
        }
        return {
            "weight_quant": cfg.weight_quant,
            "weight_quant_aux": cfg.weight_quant_aux,
            "quant_compute": cfg.quant_compute,
            "per_component_nbytes": parts,
            "total_bytes": sum(parts.values()),
        }

    @torch.inference_mode()
    def __call__(self, prompt, negative_prompt="", num_inference_steps: int = 50,
                 guidance_scale: float = 5.0, seed: int = 0,
                 output_type: str = "pil", latents=None,
                 num_images_per_prompt: int = 1, callback=None,
                 **kwargs) -> PipelineOutput:
        cfg = self.distri_config
        if "height" in kwargs or "width" in kwargs:
            raise ValueError("height and width are fixed in DistriConfig")
        if kwargs:
            raise NotImplementedError(
                f"unsupported arguments in the PyTorch port: {sorted(kwargs)} "
                "(img2img, refiner handoff and micro-conditioning are ROADMAP "
                "queue 1 item 6)"
            )
        if not cfg.do_classifier_free_guidance:
            guidance_scale = 1.0
        prompts, negs = _normalize_prompts(prompt, negative_prompt)
        self.scheduler.set_timesteps(num_inference_steps)

        def run_chunk(cp, cn, cl):
            embeds, added = self._encode(cp, cn)
            return self.runner.generate(
                cl, embeds, guidance_scale=guidance_scale,
                num_inference_steps=num_inference_steps, added_cond=added,
                callback=callback,
            )

        latent = _batched_generate(
            cfg, self.scheduler, prompts, negs, num_images_per_prompt, seed,
            latents, self.unet_config.in_channels, run_chunk,
        )
        return self._finalize(latent, output_type)

    def _decode_to_np(self, latent) -> np.ndarray:
        """latent -> float RGB [N, H, W, 3] in [0, 1], decoded in
        batch_size chunks."""
        bs = self.distri_config.batch_size
        scaling = self.vae_config.scaling_factor
        shift = self.vae_config.shift_factor
        images = []
        for i in range(0, latent.shape[0], bs):
            img = vae_mod.decode(self.vae_params, self.vae_config,
                                 latent[i:i + bs] / scaling + shift)
            images.append(img.float().cpu().numpy())
        image = np.concatenate(images, axis=0)
        return np.clip(image / 2 + 0.5, 0.0, 1.0)

    def _finalize(self, latent, output_type) -> PipelineOutput:
        weightless = any(isinstance(t, SimpleTokenizer) for t in self.tokenizers)
        if output_type == "latent":
            images = list(latent.float().cpu().numpy())
        elif output_type == "np":
            images = list(self._decode_to_np(latent))
        elif output_type == "pil":
            from PIL import Image

            images = [Image.fromarray((im * 255).round().astype(np.uint8))
                      for im in self._decode_to_np(latent)]
        else:
            raise ValueError(f"output_type must be latent, np or pil, got {output_type!r}")
        return PipelineOutput(images=images, weightless_tokenizer=weightless)

    def _clip(self, which: int, ids):
        ccfg, cparams = self.text_encoders[which]
        return clip_mod.clip_text_forward(cparams, ccfg, torch.from_numpy(ids))

    @classmethod
    def from_params(cls, distri_config, unet_config, unet_params, vae_config,
                    vae_params, text_configs, text_params, scheduler="ddim",
                    tokenizers=None):
        sched = (scheduler if isinstance(scheduler, BaseScheduler)
                 else get_scheduler(scheduler))
        toks = tokenizers or [SimpleTokenizer(tc.vocab_size) for tc in text_configs]
        return cls(distri_config, unet_config, unet_params, vae_config, vae_params,
                   sched, toks, list(zip(text_configs, text_params)))

    def _encode(self, prompts, negs):
        cfg = self.distri_config
        texts = negs + prompts if cfg.do_classifier_free_guidance else prompts
        n_br = 2 if cfg.do_classifier_free_guidance else 1
        b = len(prompts)
        out1 = self._clip(0, _tokenize(self.tokenizers[0], texts))
        out2 = self._clip(1, _tokenize(self.tokenizers[1], texts))
        emb = torch.cat([out1["hidden_states"][-2], out2["hidden_states"][-2]], dim=-1)
        emb = emb.reshape(n_br, b, *emb.shape[1:])
        pooled = out2["text_embeds"].reshape(n_br, b, -1)
        # 6 time ids for the SDXL-base add-embedding width: original size,
        # crop top-left, target size; diffusers' defaults (the generated
        # size, no crop), the same for both CFG branches
        ucfg = self.unet_config
        extra = ucfg.projection_class_embeddings_input_dim - pooled.shape[-1]
        if extra != 6 * ucfg.addition_time_embed_dim:
            raise ValueError(
                f"add-embedding expects {extra / ucfg.addition_time_embed_dim} "
                "time ids; the port supports the SDXL-base layout (6)"
            )
        ids = [cfg.height, cfg.width, 0, 0, cfg.height, cfg.width]
        time_ids = torch.tensor(ids, dtype=torch.float32, device=emb.device)
        time_ids = time_ids.expand(n_br, b, 6)
        return emb, {"text_embeds": pooled, "time_ids": time_ids}
