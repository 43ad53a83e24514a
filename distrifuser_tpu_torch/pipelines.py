"""User-facing pipelines, SDXL and SD 1.x/2.x, on one device or n ranks:
text-to-image, img2img and the base/refiner handoff.

Counterpart of distrifuser_tpu/pipelines.py (``SimpleTokenizer``,
``_tokenizer_or_fallback``, ``_config_from_snapshot``,
``_scheduler_from_snapshot``, ``_prepare_init_latents``,
``_check_scheduler_family``, ``_tokenize``, ``PipelineOutput``,
``_normalize_prompts``, ``_batched_generate``, the decoder choice of
``_build_decoder``, ``_DistriPipelineBase``, ``DistriSDXLPipeline`` and
``DistriSDPipeline`` with their ``from_pretrained``, ``from_params`` and
``_encode``).
``from_params`` builds a pipeline from in-memory parameter trees: the
port's own random init (models/*.init_*_params) or JAX trees through
``models.weights.params_from_jax``.  ``from_pretrained`` loads a local
diffusers snapshot (``unet/``, ``vae/``, ``text_encoder/`` and, for SDXL,
``text_encoder_2/``, each with its ``config.json`` and safetensors shards;
``tokenizer*/`` vocab files; ``scheduler/scheduler_config.json``) through
the pure-Python reader and tokenizer of ``native/``.  Initial noise comes
from a ``torch.Generator`` seeded with ``seed`` (its numbers differ from
JAX's); callers that need identical noise pass ``latents``.

``__call__`` takes the JAX pipeline's keywords: ``image`` and ``strength``
(img2img: the image VAE-encoded, noised to the strength's schedule point
by ``scheduler.add_noise`` and denoised from there), ``denoising_end`` and
``denoising_start`` (a run stopped at a fraction of the schedule hands its
latent to a second call, e.g. a refiner's, that resumes at the same
fraction; both round to the same step index, so matched fractions neither
skip nor repeat a step), and SDXL's micro-conditioning (``original_size``,
``crops_coords_top_left``, ``target_size``, ``aesthetic_score`` and their
``negative_*`` forms), which ``DistriSDXLPipeline._encode`` turns into 6
time ids for a base UNet or 5 for a refiner-style one; the SD family
accepts and ignores them.  Any other keyword is refused.

Under displaced patch parallelism every rank builds the same pipeline and
makes the same call: it draws the same seeded latents, encodes the same
prompts, denoises its patch (parallel/runner.py) and returns the same
image.  The decoder is the JAX package's ``_build_decoder`` choice
(``decoder_choice``): where the image is in patches (displaced or naive)
and the latent rows divide among them, each patch group decodes its rows
sequence-parallel (models/vae.py ``decode_sp``: exact, so the same image
as the whole decode) and gathers them (``vae_sp=False`` turns this off);
otherwise an image above 1024 px decodes in row tiles of 64 latent rows
(``vae.decode(..., tile=)``) and a smaller one whole.  Under data
parallelism (``dp_degree``) each image group denoises and decodes its
share of the batch and every rank returns the whole batch, in order.

Weight quantization happens at load time, as in the JAX package's
constructor: the UNet under ``DistriConfig.weight_quant`` with the
execution policy ``quant_compute`` (``"pallas"`` sends every quantized
linear through the CUDA kernel of ops/quant_matmul.py), the text encoders
and the VAE under ``weight_quant_aux`` (``_quantize_aux``), which always
densify at the consumer.  ``set_weight_quant``, ``set_quant_compute`` and
``weight_report`` are the counterparts of the JAX pipeline's hooks.

Under ``DistriConfig.use_cuda_graph`` the runner captures one CUDA graph
per UNet phase (parallel/graphs.py): ``prepare(num_inference_steps)``
captures them ahead of the first call, else the first call does; a call
at another batch or image size captures anew.  ``set_stepwise(True)``
runs the eager loop instead (the reference's ``--no_cuda_graph``).  Over
NCCL, drop the pipeline before ``destroy_process_group``: its graphs hold
NCCL work until they are freed.

Every family splits its request path into three stages that ``__call__``
runs in order and the serve plane's staged executor runs on three workers
(``prepare_stages`` -> `PipelineStages`: ``_stage_encode``,
``_denoise_chunk``, ``_decode_to_np``; JAX ``prepare_stages``), so staged
and monolithic execution are one code path and give the same bits.  The
``step_carry_*`` hooks (JAX ``step_carry_*``) expose the runner's
explicit-carry stepwise API to the serve plane's step mode, packed rows
included; ``attach_step_timeline`` records each generation's per-step wall
time and wire bytes (utils/trace.py ``StepTimeline``).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import zlib
from typing import Any, List, Optional

import numpy as np
import torch

from .models import clip as clip_mod
from .models import dit as dit_mod
from .models import mmdit as mmdit_mod
from .models import t5 as t5_mod
from .models import unet as unet_mod
from .models import vae as vae_mod
from .models.weights import (convert_clip_state_dict, convert_mmdit_state_dict,
                             convert_pixart_state_dict, convert_t5_state_dict,
                             convert_unet_state_dict,
                             convert_vae_state_dict, params_nbytes, quantize_params,
                             set_quant_compute)
from .native.bpe import CLIPTokenizer
from .native.unigram import UnigramTokenizer
from .native.safetensors import load_sharded_safetensors
from .parallel.collectives import gather_batch, gather_rows
from .parallel.compress import validate_quant_compute, validate_weight_mode
from .parallel.runner import check_graph_transport, make_runner
from .parallel.stepcache import is_shallow_at, phase_step_counts, shallow_step_count
from .schedulers import BaseScheduler, FlowMatchEulerScheduler, get_scheduler
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


def _tokenizer_or_fallback(path: str):
    """The CLIP BPE tokenizer of a snapshot's tokenizer directory, else the
    hash-based SimpleTokenizer with a loud warning: on a real snapshot a
    tokenizer that did not load would silently change every image."""
    try:
        return CLIPTokenizer(path)
    except (OSError, ValueError, KeyError) as e:
        print(
            f"WARNING: failed to load CLIP tokenizer from {path!r} "
            f"({type(e).__name__}: {e}); falling back to the hash-based "
            "SimpleTokenizer. Generated images will NOT match real-prompt "
            "outputs.",
            file=sys.stderr, flush=True,
        )
        return SimpleTokenizer()


def _config_from_snapshot(root: str, subdir: str, loader, fallback):
    """A model config from the snapshot's ``<subdir>/config.json``, as
    diffusers builds the architecture; the named preset for a bare weight
    dump without config files."""
    path = os.path.join(root, subdir, "config.json")
    return loader(path) if os.path.exists(path) else fallback()


def _scheduler_from_snapshot(root: str, name) -> BaseScheduler:
    """The scheduler ``name`` with the snapshot's
    ``scheduler/scheduler_config.json`` (prediction type, betas, train
    steps): how SD 2.x's v-prediction arrives."""
    if isinstance(name, BaseScheduler):
        return name
    kwargs = {}
    cfg_path = os.path.join(root, "scheduler", "scheduler_config.json")
    if os.path.exists(cfg_path):
        sc = unet_mod.load_config_source(cfg_path)
        for k in ("num_train_timesteps", "beta_start", "beta_end",
                  "beta_schedule", "steps_offset", "prediction_type"):
            if k in sc:
                kwargs[k] = sc[k]
    return get_scheduler(name, **kwargs)


def _prepare_init_latents(cfg, scheduler, vae_params, vae_config, image, strength,
                          num_inference_steps, n_prompts, num_images_per_prompt, seed,
                          noise=None):
    """The img2img entry of both families: (latents, start_step).  The
    image, uint8 in [0, 255] or float in [0, 1], [H, W, 3] or one per
    prompt, is VAE-encoded (its ``shift_factor`` subtracted, then scaled),
    tiled over the prompts and repeated ``num_images_per_prompt`` times
    (prompt-major, as ``_batched_generate`` expands the prompts) and noised
    to step ``start_step`` of the schedule, where ``init_timestep =
    min(max(int(steps * strength), 1), steps)`` steps remain: at least one
    always runs.  The noise comes from a ``torch.Generator`` seeded with
    ``seed`` unless ``noise`` is given."""
    if not 0.0 < strength <= 1.0:
        raise ValueError(f"strength must be in (0, 1], got {strength}")
    init_timestep = min(max(int(num_inference_steps * strength), 1), num_inference_steps)
    start_step = num_inference_steps - init_timestep
    arr = np.asarray(image)
    arr = (arr.astype(np.float32) / 255.0 if arr.dtype == np.uint8
           else arr.astype(np.float32))
    if arr.ndim == 3:
        arr = arr[None]
    if arr.min() < 0.0 or arr.max() > 1.0:
        raise ValueError("init image must be uint8 [0,255] or float [0,1] "
                         f"(got range [{arr.min():.3f}, {arr.max():.3f}])")
    n_img = arr.shape[0]
    if n_img not in (1, n_prompts):
        raise ValueError(f"{n_img} init images for {n_prompts} prompts")
    images = torch.from_numpy(arr * 2.0 - 1.0).to(cfg.device)  # the VAE's [-1, 1]
    init = vae_mod.encode(vae_params, vae_config, images)
    init = (init - vae_config.shift_factor) * vae_config.scaling_factor
    if tuple(init.shape[1:3]) != (cfg.latent_height, cfg.latent_width):
        raise ValueError(f"init image encodes to {tuple(init.shape[1:3])}, the config "
                         f"wants {(cfg.latent_height, cfg.latent_width)}")
    if n_img == 1 and n_prompts > 1:
        init = init.repeat(n_prompts, 1, 1, 1)
    init = init.repeat_interleave(num_images_per_prompt, dim=0)
    if noise is None:
        noise = torch.randn(init.shape, generator=torch.Generator().manual_seed(seed))
    else:
        noise = torch.from_numpy(np.array(noise, np.float32))
        if noise.shape != init.shape:
            raise ValueError(f"noise of shape {tuple(noise.shape)}, expected "
                             f"{tuple(init.shape)}")
    return scheduler.add_noise(init, noise.to(init.device), start_step), start_step


def _handoff_steps(num_inference_steps, denoising_start, denoising_end):
    """(start_step, end_step) of ``denoising_start`` / ``denoising_end``
    fractions: each rounds to the nearest step index, so that a run that
    ends at a fraction and one that starts at it neither skip nor repeat a
    step."""
    start_step, end_step = 0, None
    for name, frac in (("denoising_start", denoising_start),
                       ("denoising_end", denoising_end)):
        if frac is not None and not 0.0 < frac < 1.0:
            raise ValueError(f"{name} must be in (0, 1), got {frac}")
    if denoising_end is not None:
        end_step = int(round(num_inference_steps * denoising_end))
        if end_step < 1:
            raise ValueError(f"denoising_end={denoising_end} rounds to zero steps at "
                             f"num_inference_steps={num_inference_steps}")
    if denoising_start is not None:
        start_step = int(round(num_inference_steps * denoising_start))
    return start_step, end_step


def _check_scheduler_family(scheduler: BaseScheduler, family: str, flow: bool = False) -> None:
    """Refuse a sampler of the wrong kind at construction: a rectified-flow
    family (``flow``, SD3) takes the flow sampler only, the others predict
    epsilon or v over a beta schedule and refuse it.  Crossed, the two would
    run together without an error and give garbage images."""
    is_flow = scheduler.prediction_type == "flow"
    if flow and not is_flow:
        raise ValueError(
            f"{family} is a rectified-flow model family: the scheduler must be "
            f"FlowMatchEulerScheduler ('flow-euler'), got {type(scheduler).__name__}")
    if is_flow and not flow:
        raise ValueError(
            f"'flow-euler' on {family}: this family predicts epsilon/v over a beta "
            "schedule, not a rectified-flow velocity; use ddim / euler / dpm-solver "
            "('flow-euler' is for DistriSD3Pipeline)")


def _tokenize(tok, texts: List[str]) -> np.ndarray:
    if isinstance(tok, SimpleTokenizer):
        return tok(texts)
    out = tok(texts, padding="max_length", max_length=tok.model_max_length,
              truncation=True, return_tensors="np")
    return np.asarray(out["input_ids"])


@dataclasses.dataclass
class PipelineStages:
    """The stages of one prepared (pipeline, steps) pair (JAX
    ``PipelineStages``), the split request path the staged serving
    executor (serve/staging.py) pipelines across micro-batches:

    * ``encode(prompts, negs) -> embeddings`` -- tokenize + text-encode one
      batch-width chunk; the returned pair is family-opaque (UNet:
      (embeds, added_cond); DiT: (embeds, caption_mask); MMDiT: (embeds,
      pooled)) and is exactly what ``denoise`` consumes;
    * ``denoise(embeddings, latents, guidance_scale) -> latent`` -- the
      prepared denoise loop (graph replays on the card);
    * ``decode(latent) -> np images`` -- chunked VAE decode plus the
      device->host conversion, float RGB [N, H, W, 3] in [0, 1].

    Every callable is the SAME code ``__call__`` runs (``_stage_encode``
    / ``_denoise_chunk`` / ``_decode_to_np``), so staged and monolithic
    execution produce bit-identical images for identical (prompt, seed,
    steps).  ``steps`` and the guidance mode are baked in: a stage set
    serves exactly one executor identity (serve ExecKey).
    """

    steps: int
    batch_size: int
    encode: Any
    denoise: Any
    decode: Any
    init_noise_sigma: float


def _pack_enc_rows(encs, width):
    """One packed encoding from each member's SOLO encoding (JAX
    ``_pack_enc_rows``): every tensor of an encoding carries the batch at
    axis 1 (branch-major [n_br, B, ...]), and a solo encoding's rows are
    identical by construction (the executor repeats the one real prompt),
    so member r's row 0 becomes packed row r, padded to ``width`` by
    repeating the last member."""
    from .parallel import rowpack

    flats = [rowpack.tree_flatten(e) for e in encs]
    out = []
    for li in range(len(flats[0][0])):
        blocks = [f[0][li].narrow(1, 0, 1) for f in flats]
        blocks = blocks + [blocks[-1]] * (width - len(blocks))
        out.append(torch.cat(blocks, dim=1))
    return rowpack.tree_unflatten(flats[0][1], out)


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


def _wrap_chunk_callback(callback, n_real):
    """The per-step ``callback(i, t, x)`` of one chunk, shown only the
    chunk's ``n_real`` real rows (the padded tail rows stripped).  With more
    images than ``batch_size`` it fires per chunk, its step index restarting
    in each."""
    if callback is None:
        return None
    return lambda i, t, x: callback(i, t, x[:n_real])


def _batched_generate(cfg, scheduler, prompts, negs, num_images_per_prompt,
                      seed, latents, in_channels, run_chunk):
    """Any number of prompts over the fixed ``cfg.batch_size``: each prompt
    repeated ``num_images_per_prompt`` times, the list run in batch_size
    chunks with the tail padded by its last entry (padded outputs dropped).
    ``run_chunk(prompts, negs, latents, n_real)`` gets each chunk and its
    count of real rows.  Noise is drawn once for the whole expanded batch."""
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
        latents = (latents.float() if isinstance(latents, torch.Tensor)
                   else torch.as_tensor(np.asarray(latents, np.float32)))
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
        out = run_chunk(cp, cn, cl, bs - pad)
        outs.append(out[:bs - pad])
    return torch.cat(outs, dim=0)


def decoder_choice(cfg: DistriConfig):
    """(sequence-parallel?, latent rows per tile) of the decode, as the JAX
    package's ``_build_decoder`` picks it: sequence-parallel over the patch
    group where the image is in patches, ``vae_sp`` is on and the latent
    rows divide among them; else row tiles of 64 above 128 latent rows
    (1024 px), else whole (tile 0)."""
    parallel = (cfg.is_sp and cfg.vae_sp
                and cfg.latent_height % cfg.n_device_per_batch == 0)
    return parallel, 64 if not parallel and cfg.latent_height > 128 else 0


def decode_latents(cfg: DistriConfig, vae_config, vae_params, latents):
    """Latents [batch_size, h, w, 4] (already divided by the scaling) ->
    images [batch_size, 8h, 8w, 3] on every rank, by ``decoder_choice``:
    sequence-parallel (this rank's rows of its image group's share through
    models/vae.py ``decode_sp``, the rows gathered over the patch group and
    the shares over the image groups), else whole or in row tiles on every
    rank.  Nothing in it waits for the host but its collectives."""
    parallel, tile = decoder_choice(cfg)
    if not parallel:
        return vae_mod.decode(vae_params, vae_config, latents, tile=tile)
    n = cfg.n_device_per_batch
    mine = latents.chunk(cfg.dp_degree)[cfg.dp_idx()]
    rows = mine.chunk(n, dim=1)[cfg.split_idx()].contiguous()
    image = gather_rows(vae_mod.decode_sp(vae_params, vae_config, rows, n, cfg.batch_group),
                        cfg.batch_group)
    return gather_batch(image, cfg.dp_group) if cfg.dp_degree > 1 else image


def _quantize_aux(cfg, vae_params, text_encoders):
    """Load-time quantization of the auxiliary models (VAE, CLIP text
    encoders) under ``weight_quant_aux``, with the "dequant" policy, the
    VAE's encoder and decoder alike: returns ``(vae_params, [(config,
    params), ...])``."""
    q = lambda p: quantize_params(p, cfg.weight_quant_aux)  # noqa: E731
    return q(vae_params), [(tc, q(tp)) for tc, tp in text_encoders]


class _GenerationMixin:
    """What every pipeline family shares (JAX ``_GenerationMixin``): the
    weight-quantization hooks, the graph switch, the weight report and the
    decode and output tail of ``__call__``.  Needs ``distri_config``,
    ``runner``, ``vae_config``, ``vae_params``, ``text_encoders`` and
    ``tokenizers`` on the instance."""

    # the SD3 family's latent re-centring at decode (VAEConfig.shift_factor),
    # set by DistriSD3Pipeline; 0 for the other families
    _vae_shift: float = 0.0

    # the per-step denoise timeline (utils/trace.py StepTimeline), attached
    # by `attach_step_timeline`: None adds nothing to the call path
    step_timeline = None

    def attach_step_timeline(self, timeline):
        """Record every generation's per-denoise-step wall time (tagged
        warmup/full/shallow by the step cache's cadence) and live wire
        bytes into ``timeline`` (`utils.trace.StepTimeline`; JAX
        ``attach_step_timeline``).  The byte counter adds each executed
        step's per-phase bytes from ``comm_plan``'s model, so it equals
        the closed-form plan exactly iff the loop ran the phases the plan
        predicts."""
        self.step_timeline = timeline
        return timeline

    def _timeline_callback(self, num_inference_steps: int, callback,
                           start_step: int = 0, end_step=None):
        """The user's per-step callback composed with the attached
        timeline's recorder (the callback itself when none is attached).
        Steps [start, start + n_sync) are warmup, the rest follow the
        shallow-first cadence, as the denoise loops count them."""
        tl = self.step_timeline
        if tl is None:
            return callback
        cfg = self.distri_config
        steps_end = (num_inference_steps if end_step is None
                     else min(end_step, num_inference_steps))
        n_sync = min(cfg.warmup_steps + 1, steps_end - start_step)
        sc = cfg.step_cache_enabled
        interval = cfg.step_cache_interval

        def phase_of(i: int) -> str:
            if i < start_step + n_sync:
                return "warmup"
            if sc and is_shallow_at(i, start_step + n_sync, interval):
                return "shallow"
            return "full"

        try:
            bytes_per_step = self.comm_plan(num_inference_steps)["bytes_per_step"]
        except (ValueError, AttributeError, KeyError, RuntimeError):
            # a runner without a byte model, or the UNet's before its first
            # generate (its model reads the last run's buffers): timings only
            bytes_per_step = None
        tl.begin_run(steps_end - start_step, phase_of, bytes_per_step=bytes_per_step,
                     meta={"steps": num_inference_steps, "start_step": start_step,
                           "comm_compress": cfg.comm_compress})

        def cb(i, t, x):
            tl.on_step(int(i))
            if callback is not None:
                callback(i, t, x)

        return cb

    def _timeline_end(self) -> None:
        if self.step_timeline is not None:
            self.step_timeline.end_run()

    def _run_denoise(self, enc, latents, guidance_scale, num_inference_steps, *,
                     start_step=0, end_step=None, callback=None):
        """``_denoise_chunk`` of one chunk of ``__call__``, bracketed by
        the attached timeline's run (encode stays outside it)."""
        cb = self._timeline_callback(num_inference_steps, callback,
                                     start_step=start_step, end_step=end_step)
        kw = {"callback": cb}
        if start_step:
            kw["start_step"] = start_step
        if end_step is not None:
            kw["end_step"] = end_step
        try:
            return self._denoise_chunk(enc, latents, guidance_scale,
                                       num_inference_steps, **kw)
        finally:
            self._timeline_end()

    def prepare_stages(self, num_inference_steps: int) -> PipelineStages:
        """The request path as three separately dispatchable stages
        (text-encode / denoise / VAE-decode) for the staged serving
        executor to overlap across micro-batches (JAX ``prepare_stages``).
        Captures the denoiser's graphs here (the same ``prepare`` the
        monolithic path uses) and fixes the scheduler's timestep table,
        OFF the dispatch path: stage invocations never capture and never
        mutate shared scheduler state.  The callables are the exact
        functions ``__call__`` runs."""
        self.scheduler.set_timesteps(num_inference_steps)
        self.prepare(num_inference_steps)
        steps = num_inference_steps
        # __call__ forces guidance_scale to 1 when CFG is off; the staged
        # denoise applies the same normalization for identity
        cfg_on = self.distri_config.do_classifier_free_guidance

        def denoise(enc, latents, guidance_scale):
            return self._denoise_chunk(enc, latents,
                                       guidance_scale if cfg_on else 1.0, steps)

        return PipelineStages(
            steps=steps, batch_size=self.distri_config.batch_size,
            encode=self._stage_encode, denoise=denoise, decode=self._decode_to_np,
            init_noise_sigma=float(self.scheduler.init_noise_sigma))

    def _stage_encode(self, prompts, negs):
        """Encode stage: ``_encode`` without micro-conditioning (the serve
        surface has none), which resolves to the defaults ``__call__``
        passes -- the same embeddings either way."""
        return self._encode(prompts, negs)

    # -- the step-granular carry hooks (serve/executors.py step contract) --
    #
    # Every family's encoding is a pair (embeddings, the family's second
    # text input), the runner's stepwise API takes them as two arguments.

    def step_carry_init(self, latents, num_inference_steps):
        return self.runner.stepwise_carry_init(latents, num_inference_steps)

    def step_carry_step(self, carry, i, enc, guidance_scale, num_inference_steps):
        return self.runner.stepwise_carry_step(carry, i, *enc, guidance_scale,
                                               num_inference_steps)

    def step_carry_latent(self, carry):
        return self.runner.stepwise_carry_latent(carry)

    def step_carry_pack_supported(self) -> bool:
        fn = getattr(self.runner, "stepwise_rows_supported", None)
        return bool(fn()) if fn is not None else False

    def step_carry_signature(self, carry, i, num_inference_steps):
        return self.runner.stepwise_carry_signature(carry, i, num_inference_steps)

    def step_carry_rows_axes(self, carry, enc, num_inference_steps):
        return self.runner.stepwise_carry_rows_axes(carry, num_inference_steps)

    def step_carry_pack_enc(self, encs, width):
        return _pack_enc_rows(encs, width)

    def step_carry_step_rows(self, carry, i_rows, enc, gs_rows, num_inference_steps):
        return self.runner.stepwise_carry_step_rows(carry, i_rows, *enc, gs_rows,
                                                    num_inference_steps)

    def set_weight_quant(self, mode: str) -> None:
        """Quantize the denoiser's weights to ``mode`` after construction.  Only
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
        """Re-tag the denoiser's quantized kernels with an execution policy
        (DistriConfig.quant_compute); payloads and scales are untouched."""
        cfg = self.distri_config
        validate_quant_compute(policy, cfg.weight_quant)
        if policy == cfg.quant_compute:
            return
        self.runner.params = set_quant_compute(self.runner.params, policy)
        cfg.quant_compute = policy

    def step_cache_plan(self, num_inference_steps: int) -> dict:
        """How the step cache's cadence plays out over a run of
        ``num_inference_steps`` steps (JAX ``step_cache_plan``)."""
        cfg = self.distri_config
        shallow = (shallow_step_count(num_inference_steps, cfg.warmup_steps,
                                      cfg.step_cache_interval)
                   if cfg.step_cache_enabled else 0)
        return {"enabled": cfg.step_cache_enabled,
                "interval": cfg.step_cache_interval,
                "depth": cfg.step_cache_depth,
                "total_steps": num_inference_steps,
                "shallow_steps": shallow}

    def comm_plan(self, num_inference_steps: int) -> dict:
        """What one generation of ``num_inference_steps`` steps puts on the
        wire (JAX ``comm_plan``), per rank: the bytes a step of each phase
        exchanges times the phase's step count.  The UNet runner's come from
        ``comm_volume_report(per_phase=True)`` (read from its last
        generate), the transformer runners' from their closed-form
        ``comm_report``.  A configuration with no byte model (tensor or
        naive patch parallelism) raises."""
        cfg = self.distri_config
        counts = phase_step_counts(
            num_inference_steps, cfg.warmup_steps,
            cfg.step_cache_interval if cfg.step_cache_enabled else 1)
        runner = self.runner
        if hasattr(runner, "comm_volume_report"):  # the UNet families
            rep = runner.comm_volume_report(per_phase=True)
            per_step = {ph: sum(kinds.values()) for ph, kinds in rep["bytes"].items()}
            if per_step and "stale" not in per_step:  # one-phase configurations
                per_step["stale"] = per_step.get("sync", 0)
        else:  # the DiT's and the MMDiT's closed forms, a shallow step's
            # bytes scaled from the elements it exchanges
            rep = runner.comm_report()
            per_step = {"sync": rep["sync_step_collective_bytes"],
                        "stale": rep["per_step_collective_bytes"]}
            elems = rep["per_step_collective_elems"]
            if "step_cache" in rep and elems:
                per_step["shallow"] = (per_step["stale"] * rep["step_cache"][
                    "shallow_per_step_collective_elems"] // elems)
        if not per_step:
            raise ValueError(
                f"{type(runner).__name__} under parallelism="
                f"{cfg.parallelism!r} has no byte-modeled comm report: "
                "comm_plan cannot price its traffic")
        total = sum(per_step.get(ph, 0) * n for ph, n in counts.items())
        return {"comm_compress": cfg.comm_compress,
                "refresh_fraction": cfg.refresh_fraction,
                "steps": counts,
                "bytes_per_step": per_step,
                "total_bytes": int(total)}

    def generate_batch(self, prompts, negative_prompts=None, **kwargs) -> PipelineOutput:
        """The pre-bucketed batched entry (JAX ``generate_batch``; the serve
        executors' call path, serve/executors.py): EXACTLY
        ``distri_config.batch_size`` prompts, the batch the pipeline was
        prepared for, so the call is one chunk with zero padding.  Delegates
        to ``__call__``, so the one-shot and serving paths share one code
        path; ``kwargs`` are the ``__call__`` surface (num_inference_steps,
        guidance_scale, seed, latents, output_type, ...)."""
        prompts = list(prompts)
        bs = self.distri_config.batch_size
        if len(prompts) != bs:
            raise ValueError(
                f"generate_batch is the pre-bucketed entry: expected exactly "
                f"batch_size={bs} prompts, got {len(prompts)} (pad upstream "
                "— serve.executors.PipelineExecutor does — or call the "
                "pipeline directly for arbitrary counts)"
            )
        if negative_prompts is None or isinstance(negative_prompts, str):
            negs = negative_prompts or ""  # __call__ broadcasts a str
        else:
            negs = list(negative_prompts)
            if len(negs) != bs:
                raise ValueError(f"{len(negs)} negative prompts for {bs} prompts")
        if kwargs.get("num_images_per_prompt", 1) != 1:
            raise ValueError(
                "generate_batch batches across requests; "
                "num_images_per_prompt must stay 1"
            )
        return self(prompt=prompts, negative_prompt=negs, **kwargs)

    def set_progress_bar_config(self, **kwargs) -> None:
        """Accepted and ignored, as in the JAX package: the reference's
        scripts call it to silence the progress bar, which the port does
        not draw."""

    def set_stepwise(self, enabled: bool = True) -> None:
        """Run the denoiser eagerly, step by step (``enabled``), or replay its
        captured graphs (JAX ``set_stepwise``: the switch is
        ``use_cuda_graph``).  Graphs already captured are kept.  Refused
        under PipeFusion, as the JAX package refuses it."""
        cfg = self.distri_config
        if enabled and cfg.parallelism == "pipefusion":
            raise ValueError(
                "stepwise fallback does not apply to the PipeFusion patch pipeline: "
                "PipeFusionRunner has no host-driven stepwise loop, its ticks run "
                "as the replays of captured bodies (parallel/pipefusion.py); build "
                "the pipeline with parallelism='patch' to run step by step")
        previous, cfg.use_cuda_graph = cfg.use_cuda_graph, not enabled
        try:
            check_graph_transport(cfg)
        except ValueError:
            cfg.use_cuda_graph = previous
            raise

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

    def _decode_to_np(self, latent) -> np.ndarray:
        """latent -> float RGB [N, H, W, 3] in [0, 1], decoded in
        batch_size chunks (``decode_latents``; the tail chunk padded with its
        last latent, the padded images dropped, as the JAX package's
        ``_decode_chunked``) from ``latent / scaling + _vae_shift``: the
        shift is 0 for the UNet and DiT families, whatever the VAE config's
        ``shift_factor``; only the SD3 family re-centres its latents by it.
        (img2img encodes as the JAX package's ``_prepare_init_latents``
        does: it subtracts the config's shift for every family.)"""
        bs = self.distri_config.batch_size
        scaling = self.vae_config.scaling_factor
        images = []
        for i in range(0, latent.shape[0], bs):
            chunk = latent[i:i + bs]
            real = chunk.shape[0]
            if real < bs:
                chunk = torch.cat([chunk, chunk[-1:].expand(bs - real, *chunk.shape[1:])])
            img = decode_latents(self.distri_config, self.vae_config, self.vae_params,
                                 chunk / scaling + self._vae_shift)[:real]
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


class _DistriPipelineBase(_GenerationMixin):
    """What the families share: load-time quantization, the runner, the
    graph hooks and ``__call__``; each family defines ``_encode`` (its
    text-encoding recipe) and ``from_pretrained``."""

    def __init__(self, distri_config: DistriConfig, unet_config, unet_params,
                 vae_config, vae_params, scheduler: BaseScheduler, tokenizers,
                 text_encoders):
        _check_scheduler_family(scheduler, type(self).__name__)
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
        self.vae_decode_parallel, self.vae_decode_tile = decoder_choice(distri_config)

    @torch.inference_mode()
    def prepare(self, num_inference_steps: int = 50) -> None:
        """Capture the UNet's graphs for a call of ``num_inference_steps``
        steps at ``batch_size`` images ahead of the first call (JAX
        ``prepare``, the reference's record-and-capture passes); the inputs
        it captures with are placeholders.  Nothing happens without
        ``use_cuda_graph``."""
        cfg = self.distri_config
        if not cfg.use_compiled_step:
            return
        bs = cfg.batch_size
        embeds, added = self._encode([""] * bs, [""] * bs)
        latents = torch.zeros(bs, cfg.latent_height, cfg.latent_width,
                              self.unet_config.in_channels, device=cfg.device)
        self.runner.prepare(latents, embeds, num_inference_steps=num_inference_steps,
                            added_cond=added)

    @torch.inference_mode()
    def __call__(self, prompt, negative_prompt="", num_inference_steps: int = 50,
                 guidance_scale: float = 5.0, seed: int = 0,
                 output_type: str = "pil", latents=None,
                 num_images_per_prompt: int = 1, image=None, strength: float = 0.8,
                 denoising_start: Optional[float] = None,
                 denoising_end: Optional[float] = None, original_size=None,
                 crops_coords_top_left=(0, 0), target_size=None,
                 aesthetic_score: float = 6.0, negative_original_size=None,
                 negative_crops_coords_top_left=None, negative_target_size=None,
                 negative_aesthetic_score: float = 2.5, callback=None,
                 _noise=None, **kwargs) -> PipelineOutput:
        """Generate images (module docstring for the keywords).  ``_noise``
        replaces img2img's seeded noise draw (tests pass the JAX package's
        own)."""
        cfg = self.distri_config
        if "height" in kwargs or "width" in kwargs:
            raise ValueError("height and width are fixed in DistriConfig")
        if kwargs:
            raise TypeError(f"unexpected keyword arguments: {sorted(kwargs)}")
        if not cfg.do_classifier_free_guidance:
            guidance_scale = 1.0
        prompts, negs = _normalize_prompts(prompt, negative_prompt)
        self.scheduler.set_timesteps(num_inference_steps)
        start_step, end_step = _handoff_steps(num_inference_steps, denoising_start,
                                              denoising_end)
        if denoising_start is not None and (image is not None or latents is None):
            raise ValueError("denoising_start resumes the mid-trajectory latents of an "
                             "earlier stage: pass them as latents (and no image; "
                             "img2img is image + strength)")
        if image is not None:
            if latents is not None:
                raise ValueError("pass either image or latents, not both")
            latents, start_step = _prepare_init_latents(
                cfg, self.scheduler, self.vae_params, self.vae_config, image, strength,
                num_inference_steps, len(prompts), num_images_per_prompt, seed, _noise)
        micro_cond = {
            "original_size": original_size,
            "crops_coords_top_left": crops_coords_top_left,
            "target_size": target_size,
            "aesthetic_score": aesthetic_score,
            "negative_original_size": negative_original_size,
            "negative_crops_coords_top_left": negative_crops_coords_top_left,
            "negative_target_size": negative_target_size,
            "negative_aesthetic_score": negative_aesthetic_score,
        }

        def run_chunk(cp, cn, cl, n_real):
            return self._run_denoise(
                self._encode(cp, cn, micro_cond), cl, guidance_scale,
                num_inference_steps, start_step=start_step, end_step=end_step,
                callback=_wrap_chunk_callback(callback, n_real))

        latent = _batched_generate(
            cfg, self.scheduler, prompts, negs, num_images_per_prompt, seed,
            latents, self.unet_config.in_channels, run_chunk,
        )
        return self._finalize(latent, output_type)

    def _denoise_chunk(self, enc, latents, guidance_scale, num_inference_steps, *,
                       start_step=0, end_step=None, callback=None):
        embeds, added = enc
        return self.runner.generate(
            latents, embeds, guidance_scale=guidance_scale,
            num_inference_steps=num_inference_steps, added_cond=added,
            start_step=start_step, end_step=end_step, callback=callback)

    def _clip(self, which: int, ids):
        ccfg, cparams = self.text_encoders[which]
        return clip_mod.clip_text_forward(cparams, ccfg, torch.from_numpy(ids))

    @classmethod
    def from_params(cls, distri_config, unet_config, unet_params, vae_config,
                    vae_params, text_configs, text_params, scheduler="ddim",
                    tokenizers=None):
        """A pipeline from in-memory trees (the port's layout); ``scheduler``
        a name or a scheduler; hash tokenizers unless ``tokenizers``."""
        sched = (scheduler if isinstance(scheduler, BaseScheduler)
                 else get_scheduler(scheduler))
        toks = tokenizers or [SimpleTokenizer(tc.vocab_size) for tc in text_configs]
        return cls(distri_config, unet_config, unet_params, vae_config, vae_params,
                   sched, toks, list(zip(text_configs, text_params)))

    @classmethod
    def _from_snapshot(cls, distri_config, root, scheduler, dtype, variant,
                       unet_preset, vae_preset, encoders):
        """A pipeline from a local diffusers snapshot: each component's
        config from its ``config.json`` (else the preset), its weights from
        its safetensors shards (``variant`` picks e.g. the fp16 files),
        cast to ``dtype`` (default: the config's) on the config's device;
        ``encoders`` are (text encoder dir, tokenizer dir, preset config)
        per text encoder."""
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"{root!r} is not a local model directory: from_pretrained reads "
                "a diffusers snapshot (unet/, vae/, text_encoder/, tokenizer/, "
                "...) from disk and downloads nothing")
        dtype = dtype or distri_config.dtype

        def load(subdir, convert):
            sd = load_sharded_safetensors(os.path.join(root, subdir), variant=variant,
                                          skip=("position_ids",))
            return unet_mod.cast_params(convert(sd, dtype), dtype, distri_config.device)

        ucfg = _config_from_snapshot(root, "unet", unet_mod.unet_config_from_json,
                                     unet_preset)
        vcfg = _config_from_snapshot(root, "vae", vae_mod.vae_config_from_json,
                                     vae_preset)
        text_encoders, tokenizers = [], []
        for enc_dir, tok_dir, preset in encoders:
            tcfg = _config_from_snapshot(root, enc_dir, clip_mod.clip_config_from_json,
                                         preset)
            text_encoders.append((tcfg, load(enc_dir, convert_clip_state_dict)))
            tokenizers.append(_tokenizer_or_fallback(os.path.join(root, tok_dir)))
        return cls(distri_config, ucfg, load("unet", convert_unet_state_dict), vcfg,
                   load("vae", convert_vae_state_dict),
                   _scheduler_from_snapshot(root, scheduler), tokenizers, text_encoders)

    def _encode(self, prompts, negs, micro_cond=None):
        """(branch-major text embeddings [n_branches, B, L, C], added
        conditioning or None) of one chunk of prompts; ``micro_cond`` holds
        ``__call__``'s micro-conditioning keywords."""
        raise NotImplementedError


def _time_ids(cfg, n_ids: int, n_branches: int, mc) -> List[List[float]]:
    """SDXL's micro-conditioning time ids, one list per CFG branch
    (unconditional first): 6 for a base UNet (original size, crop
    top-left, target size) or 5 for a refiner-style one (original size,
    crop top-left, aesthetic score); sizes default to the generated size,
    crops to (0, 0).  The base layout's unconditional branch reuses the
    positive ids unless both ``negative_original_size`` and
    ``negative_target_size`` are given (then its crops default to (0, 0));
    the refiner layout always builds it, with ``negative_aesthetic_score``
    (default 2.5)."""
    o_sz = mc.get("original_size") or (cfg.height, cfg.width)
    crops = mc.get("crops_coords_top_left") or (0, 0)
    t_sz = mc.get("target_size") or (cfg.height, cfg.width)

    def ids(size, crop, target, score):
        if n_ids == 5:
            return [size[0], size[1], crop[0], crop[1], score]
        return [size[0], size[1], crop[0], crop[1], target[0], target[1]]

    pos = ids(o_sz, crops, t_sz, mc.get("aesthetic_score", 6.0))
    if n_branches == 1:
        return [pos]
    both_neg_sizes = (mc.get("negative_original_size") is not None
                      and mc.get("negative_target_size") is not None)
    if n_ids == 6 and not both_neg_sizes:
        return [pos, pos]
    neg = ids(mc.get("negative_original_size") or o_sz,
              mc.get("negative_crops_coords_top_left") or (0, 0),
              mc.get("negative_target_size") or t_sz,
              mc.get("negative_aesthetic_score", 2.5))
    return [neg, pos]


class DistriSDXLPipeline(_DistriPipelineBase):
    """SDXL: two text encoders' penultimate hidden states concatenated,
    pooled embeds of the second, and the micro-conditioning time ids (6
    for SDXL-base, 5 for a refiner-style add embedding)."""

    @classmethod
    def from_pretrained(cls, distri_config: DistriConfig,
                        pretrained_model_name_or_path: str, scheduler="ddim",
                        dtype=None, variant: Optional[str] = None
                        ) -> "DistriSDXLPipeline":
        """An SDXL pipeline from a local diffusers snapshot directory
        (unet/, vae/, text_encoder/, text_encoder_2/, tokenizer/,
        tokenizer_2/, scheduler/)."""
        return cls._from_snapshot(
            distri_config, pretrained_model_name_or_path, scheduler, dtype, variant,
            unet_mod.sdxl_config, vae_mod.sdxl_vae_config,
            [("text_encoder", "tokenizer", clip_mod.clip_vit_l_config),
             ("text_encoder_2", "tokenizer_2", clip_mod.open_clip_bigg_config)])

    def _encode(self, prompts, negs, micro_cond=None):
        cfg = self.distri_config
        texts = negs + prompts if cfg.do_classifier_free_guidance else prompts
        n_br = 2 if cfg.do_classifier_free_guidance else 1
        b = len(prompts)
        out1 = self._clip(0, _tokenize(self.tokenizers[0], texts))
        out2 = self._clip(1, _tokenize(self.tokenizers[1], texts))
        emb = torch.cat([out1["hidden_states"][-2], out2["hidden_states"][-2]], dim=-1)
        emb = emb.reshape(n_br, b, *emb.shape[1:])
        pooled = out2["text_embeds"].reshape(n_br, b, -1)
        # the count of time ids from the add-embedding width: 6 (SDXL-base)
        # or 5 (refiner-style)
        ucfg = self.unet_config
        extra = ucfg.projection_class_embeddings_input_dim - pooled.shape[-1]
        n_ids, rest = divmod(extra, ucfg.addition_time_embed_dim)
        if n_ids not in (5, 6) or rest:
            raise ValueError(
                f"cannot derive time ids: the add embedding takes {extra} values "
                f"beyond the pooled {pooled.shape[-1]}, {ucfg.addition_time_embed_dim} "
                "a time id; only the SDXL-base (6) and refiner-style (5) layouts "
                "exist")
        ids = _time_ids(cfg, n_ids, n_br, micro_cond or {})
        time_ids = torch.tensor(ids, dtype=torch.float32, device=emb.device)
        time_ids = time_ids[:, None].expand(n_br, b, n_ids)
        return emb, {"text_embeds": pooled, "time_ids": time_ids}


class DistriSDPipeline(_DistriPipelineBase):
    """SD 1.x / 2.x: one text encoder's final hidden state, no added
    conditioning (the micro-conditioning keywords are ignored)."""

    @classmethod
    def from_pretrained(cls, distri_config: DistriConfig,
                        pretrained_model_name_or_path: str, scheduler="ddim",
                        dtype=None, variant: Optional[str] = None
                        ) -> "DistriSDPipeline":
        """An SD 1.x / 2.x pipeline from a local diffusers snapshot
        directory (unet/, vae/, text_encoder/, tokenizer/, scheduler/)."""
        return cls._from_snapshot(
            distri_config, pretrained_model_name_or_path, scheduler, dtype, variant,
            unet_mod.sd15_config, vae_mod.sd_vae_config,
            [("text_encoder", "tokenizer", clip_mod.clip_vit_l_config)])

    def _encode(self, prompts, negs, micro_cond=None):
        # SD 1.x / 2.x has no micro-conditioning: the keywords are accepted
        # for the shared __call__ and ignored, as in the JAX package
        cfg = self.distri_config
        texts = negs + prompts if cfg.do_classifier_free_guidance else prompts
        n_br = 2 if cfg.do_classifier_free_guidance else 1
        emb = self._clip(0, _tokenize(self.tokenizers[0], texts))["last_hidden_state"]
        return emb.reshape(n_br, len(prompts), *emb.shape[1:]), None


# ---------------------------------------------------------------------------
# PixArt-α: T5 text encoder, DiT, KL VAE
# ---------------------------------------------------------------------------


def _stage_blocks(cfg: DistriConfig, dit_config, params):
    """Under PipeFusion, ``params`` with this rank's stage's blocks only
    (parallel/pipefusion.py ``stage_params``); else ``params``."""
    if cfg.parallelism != "pipefusion":
        return params
    from .parallel.pipefusion import stage_params

    return stage_params(params, dit_config, cfg.n_device_per_batch, cfg.split_idx())


def _t5_tokenizer_or_fallback(path: str, vocab_size: int):
    """The Unigram tokenizer of a snapshot's ``tokenizer/tokenizer.json``,
    else the hash-based SimpleTokenizer (T5's ids: EOS 1, BOS 0) with a
    loud warning."""
    try:
        return UnigramTokenizer(path)
    except (OSError, ValueError, KeyError) as e:
        print(
            f"WARNING: failed to load T5 tokenizer from {path!r} "
            f"({type(e).__name__}: {e}); falling back to the hash-based "
            "SimpleTokenizer. Generated images will NOT match real-prompt "
            "outputs.",
            file=sys.stderr, flush=True,
        )
        return SimpleTokenizer(vocab_size=vocab_size, eos=1, bos=0)


def _t5_tokenize(tok, texts: List[str], n: int):
    """(ids [N, n], attention mask [N, n] float32) of ``texts`` for a T5
    encoder: with the hash SimpleTokenizer the real tokens and the first
    (sentinel) EOS are attended, the EOS padding after it is not; a real
    tokenizer pads and truncates to ``n`` explicitly (its model_max_length
    is 512, the pipelines' contract ``n`` tokens)."""
    if isinstance(tok, SimpleTokenizer):
        ids = tok(texts, n)
        mask = (ids != tok.eos).astype(np.float32)
        mask[np.arange(len(ids)), np.argmax(ids == tok.eos, axis=1)] = 1.0
        return ids, mask
    out = tok(texts, padding="max_length", max_length=n, truncation=True,
              return_tensors="np")
    return np.asarray(out["input_ids"]), np.asarray(out["attention_mask"], np.float32)


class DistriPixArtPipeline(_GenerationMixin):
    """PixArt-α: T5 text encoder, PixArt's DiT driven by the displaced-patch
    DiT runner (parallel/dit_sp.py) or, under ``parallelism="pipefusion"``,
    the patch pipeline (parallel/pipefusion.py), KL VAE (JAX
    ``DistriPixArtPipeline``).

    Padded caption tokens are masked out of the cross-attention; the
    1024-class micro-conditioning on (resolution, aspect) is folded into
    the timestep embedding's bias before any quantization
    (``fold_size_condition``, exact).  ``weight_quant`` quantizes the DiT
    with ``quant_compute``; the T5 encoder and the VAE follow
    ``weight_quant_aux``.  Under ``parallelism="pipefusion"`` each rank keeps
    only its stage's blocks (with the shared parameters), cut before they are
    quantized and, from a snapshot, before they reach the card; quantized
    block by block, they hold the JAX package's depth-leading per-tile
    payloads and scales."""

    # PixArt-α trains with 120 caption tokens
    max_token_length = 120

    def __init__(self, distri_config: DistriConfig, dit_config, dit_params, vae_config,
                 vae_params, scheduler: BaseScheduler, tokenizer, t5_config, t5_params):
        from .parallel.dit_sp import DiTDenoiseRunner
        from .parallel.pipefusion import PipeFusionRunner

        _check_scheduler_family(scheduler, type(self).__name__)
        cfg = distri_config
        self.distri_config = cfg
        self.dit_config = dit_config
        self.vae_config = vae_config
        encoders = [] if t5_params is None else [(t5_config, t5_params)]
        self.vae_params, self.text_encoders = _quantize_aux(cfg, vae_params, encoders)
        self.scheduler = scheduler
        self.tokenizer = tokenizer
        self.tokenizers = [tokenizer]
        self.t5_config = t5_config
        # fold the size conditioning before quantizing: it edits a bias the
        # quantizer must see in its final form
        dit_params = dit_mod.fold_size_condition(dit_params, dit_config,
                                                 float(cfg.height), float(cfg.width))
        dit_params = _stage_blocks(cfg, dit_config, dit_params)
        dit_params = quantize_params(dit_params, cfg.weight_quant,
                                     compute=cfg.quant_compute)
        runner_cls = PipeFusionRunner if cfg.parallelism == "pipefusion" else DiTDenoiseRunner
        self.runner = runner_cls(cfg, dit_config, dit_params, scheduler)
        self.vae_decode_parallel, self.vae_decode_tile = decoder_choice(cfg)

    @classmethod
    def from_params(cls, distri_config, dit_config, dit_params, vae_config, vae_params,
                    t5_config=None, t5_params=None, scheduler="ddim", tokenizer=None):
        """A pipeline from in-memory trees; without ``t5_params`` the caption
        states are seeded pseudo-embeddings (``_encode``)."""
        sched = (scheduler if isinstance(scheduler, BaseScheduler)
                 else get_scheduler(scheduler))
        tok = tokenizer or SimpleTokenizer(
            vocab_size=t5_config.vocab_size if t5_config else 32128, eos=1, bos=0)
        return cls(distri_config, dit_config, dit_params, vae_config, vae_params, sched,
                   tok, t5_config, t5_params)

    @classmethod
    def from_pretrained(cls, distri_config: DistriConfig,
                        pretrained_model_name_or_path: str, scheduler="dpm-solver",
                        dtype=None, variant: Optional[str] = None
                        ) -> "DistriPixArtPipeline":
        """A PixArt pipeline from a local snapshot directory (transformer/,
        vae/, text_encoder/ (T5), tokenizer/, scheduler/), each config from
        its ``config.json`` (else the preset), the weights cast to ``dtype``
        (default: the config's) on the config's device."""
        root = pretrained_model_name_or_path
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"{root!r} is not a local model directory: from_pretrained reads a "
                "PixArt snapshot (transformer/, vae/, text_encoder/, tokenizer/) from "
                "disk and downloads nothing")
        dtype = dtype or distri_config.dtype

        def load(subdir, convert):
            sd = load_sharded_safetensors(os.path.join(root, subdir), variant=variant)
            return unet_mod.cast_params(convert(sd), dtype, distri_config.device)

        dcfg = _config_from_snapshot(root, "transformer", dit_mod.dit_config_from_json,
                                     dit_mod.pixart_config)
        vcfg = _config_from_snapshot(root, "vae", vae_mod.vae_config_from_json,
                                     vae_mod.sd_vae_config)
        t5cfg = _config_from_snapshot(root, "text_encoder", t5_mod.t5_config_from_json,
                                      t5_mod.t5_v1_1_xxl_config)
        dit_params = load("transformer", lambda sd: _stage_blocks(
            distri_config, dcfg, convert_pixart_state_dict(
                sd, patch_size=dcfg.patch_size, eps_channels=dcfg.out_channels,
                dtype=dtype)))
        vae_params = load("vae", lambda sd: convert_vae_state_dict(sd, dtype))
        t5_params = load("text_encoder", lambda sd: convert_t5_state_dict(sd, dtype))
        tok = _t5_tokenizer_or_fallback(os.path.join(root, "tokenizer"), t5cfg.vocab_size)
        return cls(distri_config, dcfg, dit_params, vcfg, vae_params,
                   _scheduler_from_snapshot(root, scheduler), tok, t5cfg, t5_params)

    @torch.inference_mode()
    def prepare(self, num_inference_steps: int = 20) -> None:
        """Capture the DiT's graphs for a call of ``num_inference_steps``
        steps at ``batch_size`` images ahead of the first call, from
        placeholder inputs; nothing happens without ``use_cuda_graph``."""
        cfg = self.distri_config
        if not cfg.use_compiled_step:
            return
        bs = cfg.batch_size
        emb, mask = self._encode([""] * bs, [""] * bs)
        latents = torch.zeros(bs, cfg.latent_height, cfg.latent_width,
                              self.dit_config.in_channels, device=cfg.device)
        self.runner.prepare(latents, emb, num_inference_steps=num_inference_steps,
                            cap_mask=mask)

    def _encode(self, prompts, negs):
        """(caption states [n_branches, B, 120, caption_dim], caption mask
        [n_branches, B, 120]) of one chunk, branch 0 unconditional."""
        cfg = self.distri_config
        texts = negs + prompts if cfg.do_classifier_free_guidance else prompts
        n_br = 2 if cfg.do_classifier_free_guidance else 1
        ids, mask = _t5_tokenize(self.tokenizer, texts, self.max_token_length)
        dev = cfg.device
        if not self.text_encoders:
            # weight-free smoke path: pseudo-embeddings seeded by each row's
            # id sum, every token attended.  Drawn from a torch.Generator,
            # whose numbers differ from the JAX package's jax.random draws:
            # this path tests the pipeline's plumbing, not the encoder
            emb = torch.stack([
                torch.randn(ids.shape[1], self.dit_config.caption_dim,
                            generator=torch.Generator().manual_seed(int(s) % (2**31)))
                for s in ids.sum(axis=1)]).to(dev)
            mask = np.ones(ids.shape, np.float32)
        else:
            t5cfg, t5p = self.text_encoders[0]
            emb = t5_mod.t5_encode(t5p, t5cfg, torch.from_numpy(ids).to(dev),
                                   torch.from_numpy(mask).to(dev))
        b = len(prompts)
        mask = torch.from_numpy(mask).to(dev)
        return emb.reshape(n_br, b, *emb.shape[1:]), mask.reshape(n_br, b, -1)

    @torch.inference_mode()
    def __call__(self, prompt, negative_prompt="", num_inference_steps: int = 20,
                 guidance_scale: float = 4.5, seed: int = 0, output_type: str = "pil",
                 latents=None, num_images_per_prompt: int = 1, callback=None,
                 **kwargs) -> PipelineOutput:
        """Generate images: ``prompt`` a string or a list, ``latents`` the
        initial noise [N, H/8, W/8, 4] (else drawn from a torch.Generator
        seeded with ``seed``), ``callback(i, t, latents)`` after every step;
        ``output_type`` "latent", "np" or "pil"."""
        cfg = self.distri_config
        if "height" in kwargs or "width" in kwargs:
            raise ValueError("height and width are fixed in DistriConfig")
        if kwargs:
            raise TypeError(f"unexpected keyword arguments: {sorted(kwargs)}")
        if not cfg.do_classifier_free_guidance:
            guidance_scale = 1.0
        prompts, negs = _normalize_prompts(prompt, negative_prompt)
        self.scheduler.set_timesteps(num_inference_steps)

        def run_chunk(cp, cn, cl, n_real):
            return self._run_denoise(self._encode(cp, cn), cl, guidance_scale,
                                     num_inference_steps,
                                     callback=_wrap_chunk_callback(callback, n_real))

        latent = _batched_generate(cfg, self.scheduler, prompts, negs,
                                   num_images_per_prompt, seed, latents,
                                   self.dit_config.in_channels, run_chunk)
        return self._finalize(latent, output_type)

    def _denoise_chunk(self, enc, latents, guidance_scale, num_inference_steps, *,
                       callback=None):
        emb, mask = enc
        return self.runner.generate(
            latents, emb, guidance_scale=guidance_scale,
            num_inference_steps=num_inference_steps, cap_mask=mask, callback=callback)


# ---------------------------------------------------------------------------
# SD3: CLIP-L, OpenCLIP-bigG and T5 text encoders, the MMDiT, the SD3 VAE
# ---------------------------------------------------------------------------


class DistriSD3Pipeline(_GenerationMixin):
    """SD3-class pipeline (JAX ``DistriSD3Pipeline``): the MMDiT driven by
    the displaced-patch MMDiT runner (parallel/mmdit_sp.py), rectified-flow
    Euler sampling (``FlowMatchEulerScheduler``, the only sampler it
    takes), the SD3 VAE with its latent shift added back at decode.

    The text conditioning is the published SD3 recipe: both CLIPs'
    penultimate hidden states concatenated on features and zero-padded to
    ``joint_attention_dim``; T5's states (or zeros without a T5: SD3 may
    drop it) appended along the tokens; the pooled vector the concat of
    both CLIPs' projected embeddings.  ``weight_quant`` quantizes the MMDiT
    with ``quant_compute``; the text encoders (T5 too) and the VAE follow
    ``weight_quant_aux``."""

    def __init__(self, distri_config: DistriConfig, mmdit_config, mmdit_params, vae_config,
                 vae_params, scheduler: BaseScheduler, tokenizers, text_encoders,
                 t5_config=None, t5_params=None, max_t5_tokens: int = 77):
        from .parallel.mmdit_sp import MMDiTDenoiseRunner

        _check_scheduler_family(scheduler, "DistriSD3Pipeline (SD3-class MMDiT)",
                                flow=True)
        cfg = distri_config
        self.distri_config = cfg
        self.mmdit_config = mmdit_config
        self.vae_config = vae_config
        self._vae_shift = vae_config.shift_factor
        encoders = list(text_encoders) + ([] if t5_params is None
                                          else [(t5_config, t5_params)])
        self.vae_params, self.text_encoders = _quantize_aux(cfg, vae_params, encoders)
        self.t5 = (t5_config, self.text_encoders[2][1] if t5_params is not None else None)
        self.scheduler = scheduler
        self.tokenizers = tokenizers  # [CLIP-L, bigG, T5 or None]
        self.max_t5_tokens = max_t5_tokens
        clips = self.text_encoders[:2]
        pooled_dim = sum(tc.projection_dim or tc.hidden_size for tc, _ in clips)
        if pooled_dim != mmdit_config.pooled_projection_dim:
            raise ValueError(f"CLIP projected widths sum to {pooled_dim}, but the "
                             f"transformer expects pooled_projection_dim="
                             f"{mmdit_config.pooled_projection_dim}")
        clip_dim = sum(tc.hidden_size for tc, _ in clips)
        if clip_dim > mmdit_config.joint_attention_dim:
            raise ValueError(f"CLIP hidden widths sum to {clip_dim} > joint_attention_dim "
                             f"{mmdit_config.joint_attention_dim}")
        mmdit_params = quantize_params(mmdit_params, cfg.weight_quant,
                                       compute=cfg.quant_compute)
        self.runner = MMDiTDenoiseRunner(cfg, mmdit_config, mmdit_params, scheduler)
        self.vae_decode_parallel, self.vae_decode_tile = decoder_choice(cfg)

    @classmethod
    def from_params(cls, distri_config, mmdit_config, mmdit_params, vae_config, vae_params,
                    clip_configs, clip_params, t5_config=None, t5_params=None,
                    scheduler="flow-euler", tokenizers=None, max_t5_tokens: int = 77):
        """A pipeline from in-memory trees (two CLIPs, an optional T5);
        ``scheduler`` a name or a scheduler; hash tokenizers unless
        ``tokenizers``."""
        sched = (scheduler if isinstance(scheduler, BaseScheduler)
                 else get_scheduler(scheduler))
        toks = tokenizers or [SimpleTokenizer(tc.vocab_size) for tc in clip_configs] + [
            SimpleTokenizer(t5_config.vocab_size, eos=1, bos=0) if t5_config else None]
        return cls(distri_config, mmdit_config, mmdit_params, vae_config, vae_params, sched,
                   toks, list(zip(clip_configs, clip_params)), t5_config, t5_params,
                   max_t5_tokens=max_t5_tokens)

    @classmethod
    def from_pretrained(cls, distri_config: DistriConfig,
                        pretrained_model_name_or_path: str, scheduler="flow-euler",
                        dtype=None, variant: Optional[str] = None,
                        max_t5_tokens: int = 77) -> "DistriSD3Pipeline":
        """An SD3 pipeline from a local snapshot directory (transformer/,
        vae/, text_encoder/, text_encoder_2/, tokenizer/, tokenizer_2/, and
        optionally text_encoder_3/ with tokenizer_3/: without it the T5
        states are zeros, as the published pipeline allows), each config
        from its ``config.json`` (else the SD3-medium preset), the weights
        cast to ``dtype`` (default: the config's) on the config's device.
        The flow ``shift`` comes from ``scheduler/scheduler_config.json``
        (default 3.0); ``scheduler`` must be "flow-euler" or a flow
        scheduler."""
        root = pretrained_model_name_or_path
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"{root!r} is not a local model directory: from_pretrained reads an SD3 "
                "snapshot (transformer/, vae/, text_encoder*/, tokenizer*/) from disk "
                "and downloads nothing")
        if isinstance(scheduler, BaseScheduler):
            sched = scheduler  # family-checked by __init__
        elif scheduler != "flow-euler":
            raise ValueError(f"scheduler={scheduler!r}: SD3-class MMDiTs are "
                             "rectified-flow models; only 'flow-euler' (or a "
                             "FlowMatchEulerScheduler) is valid")
        else:
            sc_path = os.path.join(root, "scheduler", "scheduler_config.json")
            shift = (unet_mod.load_config_source(sc_path).get("shift", 3.0)
                     if os.path.exists(sc_path) else 3.0)
            sched = FlowMatchEulerScheduler(shift=shift)
        dtype = dtype or distri_config.dtype

        def load(subdir, convert):
            sd = load_sharded_safetensors(os.path.join(root, subdir), variant=variant,
                                          skip=("position_ids",))
            return unet_mod.cast_params(convert(sd), dtype, distri_config.device)

        mcfg = _config_from_snapshot(root, "transformer", mmdit_mod.mmdit_config_from_json,
                                     mmdit_mod.sd3_config)
        vcfg = _config_from_snapshot(root, "vae", vae_mod.vae_config_from_json,
                                     vae_mod.sd3_vae_config)
        clips, toks = [], []
        for sub, tok_sub, preset in (
                ("text_encoder", "tokenizer",
                 lambda: dataclasses.replace(clip_mod.clip_vit_l_config(),
                                             projection_dim=768)),
                ("text_encoder_2", "tokenizer_2", clip_mod.open_clip_bigg_config)):
            ccfg = _config_from_snapshot(root, sub, clip_mod.clip_config_from_json, preset)
            clips.append((ccfg, load(sub, lambda sd: convert_clip_state_dict(sd, dtype))))
            toks.append(_tokenizer_or_fallback(os.path.join(root, tok_sub)))
        t5cfg = t5p = None
        if os.path.isdir(os.path.join(root, "text_encoder_3")):
            t5cfg = _config_from_snapshot(root, "text_encoder_3", t5_mod.t5_config_from_json,
                                          t5_mod.t5_v1_1_xxl_config)
            t5p = load("text_encoder_3", lambda sd: convert_t5_state_dict(sd, dtype))
            toks.append(_t5_tokenizer_or_fallback(os.path.join(root, "tokenizer_3"),
                                                  t5cfg.vocab_size))
        else:
            toks.append(None)
        return cls(distri_config, mcfg,
                   load("transformer", lambda sd: convert_mmdit_state_dict(sd, dtype)),
                   vcfg, load("vae", lambda sd: convert_vae_state_dict(sd, dtype)), sched,
                   toks, clips, t5cfg, t5p, max_t5_tokens=max_t5_tokens)

    @torch.inference_mode()
    def prepare(self, num_inference_steps: int = 28) -> None:
        """Capture the MMDiT's graphs for a call of ``num_inference_steps``
        steps at ``batch_size`` images ahead of the first call, from
        placeholder inputs; nothing happens without ``use_cuda_graph``."""
        cfg = self.distri_config
        if not cfg.use_compiled_step:
            return
        bs = cfg.batch_size
        enc, pooled = self._encode([""] * bs, [""] * bs)
        latents = torch.zeros(bs, cfg.latent_height, cfg.latent_width,
                              self.mmdit_config.in_channels, device=cfg.device)
        self.runner.prepare(latents, enc, pooled, num_inference_steps=num_inference_steps)

    def _encode(self, prompts, negs):
        """(text states [n_branches, B, 77 + max_t5_tokens,
        joint_attention_dim], pooled [n_branches, B, P]) of one chunk,
        branch 0 unconditional."""
        cfg, mcfg = self.distri_config, self.mmdit_config
        texts = negs + prompts if cfg.do_classifier_free_guidance else prompts
        n_br = 2 if cfg.do_classifier_free_guidance else 1
        states, pooleds = [], []
        for which in range(2):
            ccfg, cparams = self.text_encoders[which]
            ids = torch.from_numpy(_tokenize(self.tokenizers[which], texts))
            out = clip_mod.clip_text_forward(cparams, ccfg, ids)
            states.append(out["hidden_states"][-2])
            pooleds.append(out.get("text_embeds", out["pooler_output"]))
        clip_emb = torch.cat(states, dim=-1)
        clip_emb = torch.nn.functional.pad(
            clip_emb, (0, mcfg.joint_attention_dim - clip_emb.shape[-1]))
        pooled = torch.cat(pooleds, dim=-1)
        t5cfg, t5p = self.t5
        if t5p is None:
            t5_emb = clip_emb.new_zeros(clip_emb.shape[0], self.max_t5_tokens,
                                        mcfg.joint_attention_dim)
        else:
            ids, mask = _t5_tokenize(self.tokenizers[2], texts, self.max_t5_tokens)
            dev = t5p["shared"].device
            t5_emb = t5_mod.t5_encode(t5p, t5cfg, torch.from_numpy(ids).to(dev),
                                      torch.from_numpy(mask).to(dev))
        enc = torch.cat([clip_emb, t5_emb.to(clip_emb.dtype)], dim=1)
        b = len(prompts)
        return enc.reshape(n_br, b, *enc.shape[1:]), pooled.reshape(n_br, b, -1)

    @torch.inference_mode()
    def __call__(self, prompt, negative_prompt="", num_inference_steps: int = 28,
                 guidance_scale: float = 7.0, seed: int = 0, output_type: str = "pil",
                 latents=None, num_images_per_prompt: int = 1, image=None,
                 strength: float = 0.8, callback=None, _noise=None,
                 **kwargs) -> PipelineOutput:
        """Generate images: ``prompt`` a string or a list, ``latents`` the
        initial noise [N, H/8, W/8, 16] (else drawn from a torch.Generator
        seeded with ``seed``); img2img with ``image`` and ``strength``, the
        encoded image moved to the strength's sigma by the flow
        ``add_noise`` (``_noise`` replaces its seeded noise draw: tests pass
        the JAX package's own); ``callback(i, t, latents)`` after every
        step; ``output_type`` "latent", "np" or "pil"."""
        cfg = self.distri_config
        if "height" in kwargs or "width" in kwargs:
            raise ValueError("height and width are fixed in DistriConfig")
        if kwargs:
            raise TypeError(f"unexpected keyword arguments: {sorted(kwargs)}")
        if not cfg.do_classifier_free_guidance:
            guidance_scale = 1.0
        prompts, negs = _normalize_prompts(prompt, negative_prompt)
        self.scheduler.set_timesteps(num_inference_steps)
        start_step = 0
        if image is not None:
            if latents is not None:
                raise ValueError("pass either image or latents, not both")
            latents, start_step = _prepare_init_latents(
                cfg, self.scheduler, self.vae_params, self.vae_config, image, strength,
                num_inference_steps, len(prompts), num_images_per_prompt, seed, _noise)

        def run_chunk(cp, cn, cl, n_real):
            return self._run_denoise(self._encode(cp, cn), cl, guidance_scale,
                                     num_inference_steps, start_step=start_step,
                                     callback=_wrap_chunk_callback(callback, n_real))

        latent = _batched_generate(cfg, self.scheduler, prompts, negs,
                                   num_images_per_prompt, seed, latents,
                                   self.mmdit_config.in_channels, run_chunk)
        return self._finalize(latent, output_type)

    def _denoise_chunk(self, enc, latents, guidance_scale, num_inference_steps, *,
                       start_step=0, callback=None):
        emb, pooled = enc
        return self.runner.generate(
            latents, emb, pooled, guidance_scale=guidance_scale,
            num_inference_steps=num_inference_steps, start_step=start_step,
            callback=callback)
