"""Adapters from the port's pipelines to the serve executor contract.

A serve executor owns one *prepared* pipeline at one bucket resolution:
DistriConfig fixes height/width at construction (the captured graphs'
shapes), so the bucket table in serve/batcher.py maps requests onto a small
set of pipeline instances, and the `ExecutorCache` bounds how many stay
resident.

Per-request seeds inside one coalesced batch are honored by drawing each
request's initial latent from its own seeded generator here and handing
the stacked batch to the pipeline's pre-bucketed entry (`generate_batch`):
exactly the noise a solo ``pipe(prompt, seed=seed)`` call draws (a CPU
``torch.Generator`` seeded with the request's seed, scaled by the
scheduler's ``init_noise_sigma``), and batch rows are independent end to
end, so coalescing never changes a request's image.

The whole-batch contract (``__call__``) is what this step of ROADMAP item
16 ports; the JAX package's staged contract (``encode_stage`` /
``denoise_stage`` / ``decode_stage``), its step-granular contract and
``attach_prompt_cache`` come with later steps.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional, Sequence

import torch

from .cache import ExecKey
from .errors import DegradationInapplicableError, is_oom
from .faults import FaultPlan


class PipelineExecutor:
    """Wrap a prepared port pipeline as a serve executor.

    ``pipeline`` must match the key it serves: built at (key.height,
    key.width) with do_classifier_free_guidance == key.cfg and the key's
    scheduler family; ``prepare(key.steps)`` should already have run (the
    factory in `pipeline_executor_factory` does all of this).  Only a
    pipeline on one rank is served: serving over n ranks needs rank 0 to
    drive the followers' dispatches (ROADMAP item 16, step 16f).

    ``fault_plan`` (serve/faults.py) injects at site ``"executor.execute"``
    for direct (server-less) executor use; a server-driven executor gets
    its faults from the server's own ``"execute"`` site instead.
    """

    def __init__(self, pipeline, steps: int, *,
                 key: Optional[ExecKey] = None,
                 fault_plan: Optional[FaultPlan] = None):
        cfg = pipeline.distri_config
        if cfg.world_size > 1:
            raise ValueError(
                f"PipelineExecutor serves a pipeline on one rank; this one "
                f"runs on {cfg.world_size} ranks.  Serving over n ranks needs "
                "rank 0 to drive the followers' dispatches, which comes with "
                "ROADMAP item 16, step 16f")
        self.pipeline = pipeline
        self.steps = steps
        self.key = key
        self.fault_plan = fault_plan
        self.batch_size = cfg.batch_size
        # scheduler timesteps are per-(pipeline, steps) state: fix them
        # ONCE here, on the prepare path -- never from the per-dispatch
        # latent draw, which must not mutate shared scheduler state
        pipeline.scheduler.set_timesteps(steps)
        # per-invocation shallow-step count under the step-cache cadence
        # (0 with the cache off) -- the server's shallow-share metrics read
        # this off every executor it dispatches to
        self.shallow_steps = pipeline.step_cache_plan(steps)["shallow_steps"]
        # weight ledger entry (pipelines.weight_report): what this
        # executor's resident weight trees cost on the device, quantization
        # included -- surfaced per key by ExecutorCache.weight_bytes
        report = getattr(pipeline, "weight_report", None)
        self.weight_nbytes = report()["total_bytes"] if report else None

    def comm_plan(self) -> dict:
        """The closed-form wire-byte plan for one dispatch at this
        executor's step count (pipelines.comm_plan)."""
        return self.pipeline.comm_plan(self.steps)

    def _in_channels(self) -> int:
        pipe = self.pipeline
        for attr in ("unet_config", "dit_config", "mmdit_config"):
            cfg = getattr(pipe, attr, None)
            if cfg is not None:
                return cfg.in_channels
        raise AttributeError(f"{type(pipe).__name__} has no model config")

    def _draw_latents(self, seeds: Sequence[int]) -> torch.Tensor:
        """Per-request seeded initial noise, float32 on the CPU: each row
        the draw a solo ``pipe(prompt, seed=s)`` makes (``_batched_generate``
        with one image), so a served image equals its solo call's."""
        cfg = self.pipeline.distri_config
        shape = (1, cfg.latent_height, cfg.latent_width, self._in_channels())
        sigma = self.pipeline.scheduler.init_noise_sigma
        return torch.cat([
            torch.randn(shape, generator=torch.Generator().manual_seed(int(s))) * sigma
            for s in seeds])

    def _pad_batch(self, prompts, negative_prompts, seeds):
        """Pad to the prepared batch width by repeating the tail (same
        convention as pipelines._batched_generate); callers drop padded
        outputs."""
        n_real = len(prompts)
        pad = (-n_real) % self.batch_size
        if pad:
            prompts = list(prompts) + [prompts[-1]] * pad
            negative_prompts = (list(negative_prompts)
                                + [negative_prompts[-1]] * pad)
            seeds = list(seeds) + [seeds[-1]] * pad
        return list(prompts), list(negative_prompts), list(seeds), n_real

    def __call__(
        self,
        prompts: List[str],
        negative_prompts: List[str],
        guidance_scale: float,
        seeds: List[int],
    ) -> List[Any]:
        if self.fault_plan is not None:
            self.fault_plan.check("executor.execute", key=self.key,
                                  batch_size=len(prompts))
        prompts, negative_prompts, seeds, n_real = self._pad_batch(
            prompts, negative_prompts, seeds)
        bs = self.batch_size
        device = torch.device(self.pipeline.distri_config.device)
        # the server's watchdog runs each dispatch on a fresh thread: make
        # this pipeline's card current there, so every launch (and graph
        # replay) lands on it
        on_card = (torch.cuda.device(device) if device.type == "cuda"
                   else contextlib.nullcontext())
        latents = self._draw_latents(seeds)
        images: List[Any] = []
        try:
            with on_card:
                # a batch wider than the prepared width (batcher
                # max_batch_size > pipeline batch_size) runs as several
                # exactly-bs calls of the same prepared pipeline
                for i in range(0, len(prompts), bs):
                    out = self.pipeline.generate_batch(
                        prompts[i:i + bs],
                        negative_prompts[i:i + bs],
                        num_inference_steps=self.steps,
                        guidance_scale=guidance_scale,
                        latents=latents[i:i + bs],
                        output_type="np",
                    )
                    images.extend(out.images)
        except Exception as exc:
            if not is_oom(exc):
                raise
            # free what the failed call allocated before the ladder
            # rebuilds: the activations of the frames below live only as
            # long as the traceback that reaches them
            latents = images = None
            raise exc.with_traceback(None)
        return images[:n_real]


def apply_key_policy(pipeline, key: ExecKey) -> None:
    """Make the built pipeline honor the key's degradation-relevant
    fields even when ``build_pipeline`` ignored them (JAX
    ``serve.executors.apply_key_policy``).

    The degradation ladder (serve/resilience.py) produces keys with the
    step cache disabled, ``exec_mode="stepwise"`` or
    ``weight_quant="int8"``; build functions construct their DistriConfig from
    (height, width, cfg, scheduler) and may ignore the rest.  Each degraded
    direction is safe to force post-construction and pre-`prepare()`:
    turning the cadence or the compression OFF removes work, quantizing
    the built dense tree is what load-time quantization does, and the
    stepwise switch is the pipeline's own `set_stepwise` hook.  (The
    opposite directions -- a key *requesting* a cadence or a mode the
    build function didn't configure -- are the build function's job.)  A field that can
    never be forced onto this build function raises
    `DegradationInapplicableError` naming the rung, so the server's retry
    loop retracts the rung instead of retrying into the same wall."""
    dcfg = pipeline.distri_config
    # the strategy is chosen at pipeline build: a build function must construct
    # from key.parallelism / key.pipe_patches
    if (key.parallelism == "pipefusion") != (dcfg.parallelism == "pipefusion"):
        raise DegradationInapplicableError(
            f"key wants parallelism={key.parallelism!r} but the build function "
            f"constructed {dcfg.parallelism!r} — build_pipeline must read "
            "key.parallelism", rung="pipeline_off")
    if key.parallelism == "pipefusion" and key.pipe_patches:
        built = getattr(getattr(pipeline, "runner", None), "patches",
                        dcfg.pipe_patches)
        if built != key.pipe_patches:
            raise DegradationInapplicableError(
                f"key wants pipe_patches={key.pipe_patches} but the "
                f"build function constructed {built} — build_pipeline must read "
                "key.pipe_patches", rung="pipeline_off")
    if (key.step_cache_interval == 1
            and (dcfg.step_cache_interval, dcfg.step_cache_depth) != (1, 0)):
        dcfg.step_cache_interval = 1
        dcfg.step_cache_depth = 0
    if key.comm_compress == "none" and dcfg.comm_compress != "none":
        dcfg.comm_compress = "none"
    # PCPP partial refresh: the reset direction (key at 1.0) always forces
    # safely; the partial direction only onto the gather layout, whose
    # refresh path honors it -- elsewhere the build function must read the field
    if (key.parallelism == "patch" and dcfg.parallelism == "patch"
            and dcfg.refresh_fraction != key.refresh_fraction):
        if key.refresh_fraction >= 1.0:
            dcfg.refresh_fraction = 1.0
        elif dcfg.attn_impl == "gather":
            from ..parallel.compress import validate_refresh_fraction

            validate_refresh_fraction(key.refresh_fraction)
            dcfg.refresh_fraction = float(key.refresh_fraction)
        else:
            raise ValueError(
                f"key wants refresh_fraction={key.refresh_fraction} but "
                f"the build function constructed attn_impl={dcfg.attn_impl!r} — "
                "partial refresh is forcible onto the gather layout only; "
                "build_pipeline must read key.refresh_fraction itself"
            )
    # weight_quant: the QUANTIZE direction is the safe force (the ladder's
    # weight_quant_on rung depends on it); a full-precision key against a
    # quantized build function raises inside set_weight_quant, since the dense
    # kernels are gone
    if key.weight_quant != dcfg.weight_quant:
        try:
            pipeline.set_weight_quant(key.weight_quant)
        except ValueError as exc:
            raise DegradationInapplicableError(
                str(exc), rung="weight_quant_on") from exc
    # quant_compute re-tags the execution policy of the quantized kernels
    # (no payload change): safe in both directions; a dense key's policy
    # has nothing to route (serve/cache.py ExecKey)
    if key.weight_quant != "none" and key.quant_compute != dcfg.quant_compute:
        pipeline.set_quant_compute(key.quant_compute)
    if key.exec_mode in ("stepwise", "step"):
        try:
            pipeline.set_stepwise(True)
        except ValueError as exc:
            raise DegradationInapplicableError(
                str(exc), rung="stepwise_fallback") from exc


def pipeline_executor_factory(
    build_pipeline: Callable[[ExecKey], Any],
    fault_plan: Optional[FaultPlan] = None,
) -> Callable[[ExecKey], PipelineExecutor]:
    """Executor factory for `InferenceServer` from a pipeline build function.

    ``build_pipeline(key)`` constructs the pipeline for a bucket -- e.g. a
    DistriConfig at (key.height, key.width) with
    do_classifier_free_guidance=key.cfg and the serving batch width, then
    ``from_params`` / ``from_pretrained`` with key.scheduler.  The factory
    forces the key's policy (`apply_key_policy`) and runs `prepare`, which
    captures the denoiser's CUDA graphs, so cache misses pay the full cost
    HERE, off the per-request path, and hands back a ready executor.
    Before the build it returns the caching allocator's free blocks to the
    card (``torch.cuda.empty_cache``), so a rebuild after an OOM starts
    from what the failed call gave back.  ``fault_plan`` injects at sites
    ``"executor.build"`` / ``"executor.execute"``.
    """

    def factory(key: ExecKey) -> PipelineExecutor:
        if fault_plan is not None:
            fault_plan.check("executor.build", key=key)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        pipe = build_pipeline(key)
        apply_key_policy(pipe, key)
        pipe.prepare(key.steps)
        return PipelineExecutor(pipe, key.steps, key=key,
                                fault_plan=fault_plan)

    return factory
