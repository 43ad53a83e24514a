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

Three contracts, as in the JAX package (serve/executors.py):

* whole-batch (``__call__``): one dispatch runs encode, denoise and decode;
* staged (``encode_stage`` / ``denoise_stage`` / ``decode_stage``, driven
  by serve/staging.py): the same three stages of the pipeline's
  ``prepare_stages``, each on a worker thread of its own.  On the card
  each stage issues its work on a CUDA stream of its own (encode, denoise
  and decode: the text encoders and the VAE then run beside another
  batch's graph replays instead of queueing behind them) and synchronises
  that stream before it returns -- the JAX package's
  ``block_until_ready`` -- so a stage's service time is its device work
  and the next stage reads finished tensors.  A stage drops the inputs it
  consumed only after that synchronise, so the caching allocator never
  hands their memory out while a kernel still reads it;
* step-granular (``step_begin`` ... ``step_run`` ... ``step_finish``,
  driven by serve/stepbatch.py): one request a work, its denoise carry
  held here and advanced one step at a time on the device's current
  stream; same-signature works pack into one evaluation
  (parallel/rowpack.py).

``attach_prompt_cache`` puts serve/promptcache.py's LRU in front of every
encode; a monolithic dispatch then runs the stages serially, which are
bit-identical to ``generate_batch``.  Every stage and step call makes the
pipeline's card current and enters ``torch.inference_mode`` on its own
thread: the server's watchdog and the stage workers call from threads of
their own.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..parallel import rowpack
from .cache import ExecKey
from .errors import DegradationInapplicableError, MigrationRejectedError, is_oom
from .faults import FaultPlan


def _tokenizer_hash(pipeline) -> int:
    """Stable identity of a pipeline's tokenizer stack for the prompt
    cache key (JAX ``_tokenizer_hash``): two executors of the same model
    share entries; a different vocabulary (or tokenizer implementation)
    never does."""
    import zlib

    parts = []
    toks = getattr(pipeline, "tokenizers", None)
    if toks is None:
        toks = [getattr(pipeline, "tokenizer", None)]
    for tok in toks or ():
        if tok is None:
            continue
        parts.append(type(tok).__name__)
        vocab = getattr(tok, "vocab_size", None)
        if vocab is None:
            enc = getattr(tok, "encoder", None)
            vocab = len(enc) if hasattr(enc, "__len__") else 0
        parts.append(str(vocab))
    return zlib.crc32("|".join(parts).encode())


class PipelineExecutor:
    """Wrap a prepared port pipeline as a serve executor.

    ``pipeline`` must match the key it serves: built at (key.height,
    key.width) with do_classifier_free_guidance == key.cfg and the key's
    scheduler family; ``prepare(key.steps)`` should already have run (the
    factory in `pipeline_executor_factory` does all of this).  A pipeline
    over n ranks has one executor a rank: serve/ranks.py runs each of
    their operations on every rank at once (rank 0's server drives the
    others), and only rank 0's images are served.

    Besides the monolithic ``__call__`` contract, the executor exposes the
    three-stage contract the staged serving pipeline (serve/staging.py)
    drives and the step-granular contract of the slot pool
    (serve/stepbatch.py), both built on the pipeline's own stage and
    carry hooks: staged, step and monolithic dispatch produce
    bit-identical images.

    ``fault_plan`` (serve/faults.py) injects at site ``"executor.execute"``
    for direct (server-less) executor use; a server-driven executor gets
    its faults from the server's own ``"execute"`` site instead.
    """

    def __init__(self, pipeline, steps: int, *,
                 key: Optional[ExecKey] = None,
                 fault_plan: Optional[FaultPlan] = None):
        cfg = pipeline.distri_config
        self.pipeline = pipeline
        # ranks the pipeline spans (serve/replica.py refuses a replica
        # whose executor spans more than one)
        self.world_size = cfg.world_size
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
        self._stages = None
        self.device = torch.device(cfg.device)
        # one CUDA stream a stage on the card (module docstring)
        self._streams: Dict[str, Any] = {}
        # prompt/embedding LRU (serve/promptcache.py), attached by the
        # owning server via attach_prompt_cache: None = encode always runs
        self.prompt_cache = None
        self._encode_cache_family = (type(pipeline).__name__,
                                     _tokenizer_hash(pipeline))
        # packed cohort dispatch state (step_run): pipeline support flag
        # (resolved lazily), rowpack plans cached per carry structure
        # (None = ambiguous -> that structure stays sequential), and the
        # last step_run's pack-efficiency tallies for the server's
        # stepbatch_* counters / fill gauge
        self._pack_supported: Optional[bool] = None
        self._pack_axes: Dict[Any, Any] = {}
        self.step_pack_stats = {"dispatches": 0, "packed_rows": 0,
                                "rows_capacity": 0}

    # -- observability -----------------------------------------------------

    def attach_step_timeline(self, timeline):
        """Record a per-denoise-step timeline (`utils.trace.StepTimeline`)
        for every monolithic dispatch through this executor: wall time
        per step tagged warmup/full/shallow plus live wire-byte counters
        reconciled against `comm_plan`."""
        return self.pipeline.attach_step_timeline(timeline)

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

    @contextlib.contextmanager
    def _on_card(self, stage: Optional[str] = None):
        """The pipeline's card current, inference mode on, and on the card
        ``stage``'s own CUDA stream (the current stream when None): what
        every stage and step call runs under, on whatever thread calls it."""
        with torch.inference_mode():
            if self.device.type != "cuda":
                yield
                return
            with torch.cuda.device(self.device):
                if stage is None:
                    yield
                    return
                stream = self._streams.get(stage)
                if stream is None:
                    stream = self._streams[stage] = torch.cuda.Stream(self.device)
                with torch.cuda.stream(stream):
                    yield

    def _sync(self) -> None:
        """Wait for the work issued on the current stream (JAX
        ``block_until_ready``): a stage's or step's time is device time."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def attach_prompt_cache(self, cache):
        """Use ``cache`` (serve/promptcache.py) in front of every encode:
        repeated prompt chunks skip tokenize + text-encode.  Monolithic
        dispatch reroutes through the stages (encode -> denoise -> decode
        run serially), which are bit-identical to `generate_batch` per
        (prompt, seed, steps), so caching changes latency, never images."""
        self.prompt_cache = cache
        return cache

    def _encode_chunk(self, p_chunk, n_chunk):
        """One batch-width encode, memoized by (family, tokenizer hash,
        prompt chunk) when a prompt cache is attached.  A cached entry is
        the encoder's own output, never a graph's static input."""
        stages = self.prepare_stages()
        if self.prompt_cache is None:
            return stages.encode(p_chunk, n_chunk)
        key = (self._encode_cache_family, tuple(p_chunk), tuple(n_chunk))
        return self.prompt_cache.get_or_encode(
            key, lambda: stages.encode(p_chunk, n_chunk))

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
        if self.prompt_cache is not None:
            # cached-encode path: the stages run serially (see
            # attach_prompt_cache) so the memoized embeddings slot in
            work = self.encode_stage(prompts, negative_prompts, seeds)
            work = self.denoise_stage(work, guidance_scale)
            return self.decode_stage(work)
        prompts, negative_prompts, seeds, n_real = self._pad_batch(
            prompts, negative_prompts, seeds)
        bs = self.batch_size
        latents = self._draw_latents(seeds)
        images: List[Any] = []
        try:
            # the server's watchdog runs each dispatch on a fresh thread:
            # make this pipeline's card current there, so every launch (and
            # graph replay) lands on it
            with self._on_card():
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


    # -- staged contract (serve/staging.py) --------------------------------

    def prepare_stages(self):
        """The pipeline's stages at this executor's step count (one
        `PipelineStages` per executor).  `pipeline_executor_factory` builds
        them with the executor, so the graph capture inside never runs on
        a stage worker beside another batch's replay."""
        if self._stages is None:
            self._stages = self.pipeline.prepare_stages(self.steps)
        return self._stages

    def encode_stage(self, prompts: List[str], negative_prompts: List[str],
                     seeds: List[int]) -> Dict[str, Any]:
        """Stage 1: pad, tokenize + text-encode every batch-width chunk and
        draw the per-request seeded latents -- encoder/host work that rides
        in the shadow of another batch's denoise."""
        prompts, negative_prompts, seeds, n_real = self._pad_batch(
            prompts, negative_prompts, seeds)
        bs = self.batch_size
        latents = self._draw_latents(seeds)
        with self._on_card("encode"):
            encoded = [self._encode_chunk(prompts[i:i + bs], negative_prompts[i:i + bs])
                       for i in range(0, len(prompts), bs)]
            self._sync()
        return {"n_real": n_real, "encoded": encoded, "latents": latents,
                # cached embeddings belong to the cache: the denoise must
                # not count them as consumed
                "encode_cached": self.prompt_cache is not None,
                "latent": None}

    def denoise_stage(self, work: Dict[str, Any],
                      guidance_scale: float) -> Dict[str, Any]:
        """Stage 2: the prepared denoise loop -- the card's bottleneck the
        other stages hide behind.  Its consumed inputs (initial latents,
        embeddings) are dropped once its stream is synchronised, so the
        next in-flight batch reuses their memory."""
        stages = self.prepare_stages()
        bs = self.batch_size
        lats = work["latents"]
        with self._on_card("denoise"):
            outs = [stages.denoise(enc, lats[i * bs:(i + 1) * bs], guidance_scale)
                    for i, enc in enumerate(work["encoded"])]
            latent = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
            self._sync()
        del work["encoded"], work["latents"]
        work["latent"] = latent
        return work

    def decode_stage(self, work: Dict[str, Any]) -> List[Any]:
        """Stage 3: chunked VAE decode + device->host conversion, padded
        rows stripped -- per-request np images, as ``__call__`` returns."""
        stages = self.prepare_stages()
        with self._on_card("decode"):
            images = stages.decode(work["latent"])
            self._sync()
        del work["latent"]
        return list(images)[:work["n_real"]]

    # -- step-granular contract (serve/stepbatch.py) -----------------------
    #
    # One request a work: the slot pool holds each request's denoise carry
    # (latent, step-cache / patch buffers, scheduler state) and advances it
    # one step at a time, so requests join/leave/park between steps.  A solo
    # step runs the request padded to the prepared batch width alone; batch
    # rows are independent end to end, so who else occupies the pool can
    # never touch this request's numerics, and a parked carry resumes
    # bit-identically: same per-step evaluations, same inputs, same order.

    def step_begin(self, prompt: str, negative_prompt: str, seed: int,
                   guidance_scale: float) -> Dict[str, Any]:
        """Admit one request into step-granular execution: encode (via
        the prompt cache when attached), draw the request's seeded
        latent, and initialize the explicit denoise carry.  Returns the
        work dict `step_run`/`step_finish`/`step_preview` consume."""
        pipe = self.pipeline
        if not hasattr(getattr(pipe, "runner", None), "stepwise_carry_init"):
            raise AttributeError(
                f"{type(pipe).__name__} has no step-granular carry hooks "
                "(PipeFusion runners have no host-driven per-step loop)")
        prompts, negs, seeds, _ = self._pad_batch([prompt], [negative_prompt], [seed])
        bs = self.batch_size
        latents = self._draw_latents(seeds[:bs])
        with self._on_card():
            enc = self._encode_chunk(prompts[:bs], negs[:bs])
            carry = pipe.step_carry_init(latents, self.steps)
            self._sync()
        # __call__ forces guidance_scale to 1 when CFG is off; the step
        # path applies the same normalization
        cfg_on = pipe.distri_config.do_classifier_free_guidance
        return {
            "carry": carry,
            "enc": enc,
            "gs": guidance_scale if cfg_on else 1.0,
            "i": 0,
            # which batch row of the carry is this request's REAL row --
            # 0 in the solo layout; a packed dispatch re-homes it
            "row": 0,
            "encode_cached": self.prompt_cache is not None,
        }

    # -- packed cohort dispatch (parallel/rowpack.py) ----------------------

    def _step_pack_supported(self) -> bool:
        if self._pack_supported is None:
            fn = getattr(self.pipeline, "step_carry_pack_supported", None)
            self._pack_supported = bool(fn()) if fn is not None else False
        return self._pack_supported

    def step_signature(self, work: Dict[str, Any]):
        """Hashable pack-compatibility key of this work's NEXT step:
        works sharing a signature run the same per-step evaluation and
        may pack into one dispatch's batch rows.  ``None`` = this work
        can only run sequentially (unsupported pipeline or config).  The
        executor's identity is part of the key -- packing never spans
        executors -- and so is the carry's structure, which grows at the
        first step (buffers, DPM++ 2M's history): carries of one signature
        but two structures cannot share a packed carry."""
        if not self._step_pack_supported():
            return None
        sig = self.pipeline.step_carry_signature(work["carry"], work["i"], self.steps)
        return (id(self), sig, rowpack.tree_flatten(work["carry"])[1])

    def _step_axes(self, work: Dict[str, Any]):
        """The rowpack per-leaf plan for this work's carry structure
        (cached per structure -- a carry's buffers and scheduler history
        appear after its first step, so one executor sees more than one).
        ``None`` = ambiguous layout; that structure stays sequential."""
        key = rowpack.tree_flatten(work["carry"])[1]
        if key not in self._pack_axes:
            try:
                self._pack_axes[key] = self.pipeline.step_carry_rows_axes(
                    work["carry"], work["enc"], self.steps)
            except rowpack.AmbiguousPackAxisError:
                self._pack_axes[key] = None
        return self._pack_axes[key]

    def _step_ensure_solo(self, work: Dict[str, Any]) -> None:
        """Normalize a work back to the SOLO carry layout: its real row
        extracted from the shared packed carry and tiled across the
        width -- byte-identical to a never-packed carry (a solo carry's
        rows are identical by construction).  Park/export/migration and
        singleton dispatches all run through this, so the snapshot format
        and the solo per-step evaluations never see packed state."""
        grp = work.pop("pack", None)
        if grp is None:
            return
        work["carry"] = rowpack.extract_row(
            work["carry"], work.get("row", 0), grp["axes"], self.batch_size)
        work["row"] = 0

    def _step_solo_one(self, work: Dict[str, Any]) -> None:
        """One sequential step: the per-slot dispatch."""
        self._step_ensure_solo(work)
        work["carry"] = self.pipeline.step_carry_step(
            work["carry"], work["i"], work["enc"], work["gs"], self.steps)
        work["i"] += 1
        stats = self.step_pack_stats
        stats["dispatches"] += 1
        stats["packed_rows"] += 1
        stats["rows_capacity"] += self.batch_size

    def _step_dispatch_packed(self, members: List[Dict[str, Any]]) -> None:
        """Advance a same-signature group in ONE evaluation: member r's
        real row rides batch row r of a shared packed carry, its step
        index and guidance scale ride [B] vectors.  Fast path: when the
        whole group is the SAME pack as last round (same shared carry,
        full membership, rows 0..n-1) the carry re-dispatches as-is --
        zero repack work in the steady state.  Otherwise the members'
        rows (solo or previously packed) repack into a fresh shared
        carry.  Ambiguous layouts fall back to sequential."""
        pipe = self.pipeline
        bs = self.batch_size
        n = len(members)
        stats = self.step_pack_stats
        grp0 = members[0].get("pack")
        fast = (
            grp0 is not None
            and grp0.get("n") == n
            and all(m.get("pack") is grp0 for m in members)
            and all(m["carry"] is members[0]["carry"] for m in members)
            and sorted(m.get("row", 0) for m in members) == list(range(n))
        )
        if fast:
            members = sorted(members, key=lambda m: m["row"])
            carry, enc, grp = members[0]["carry"], grp0["enc"], grp0
        else:
            axes = self._step_axes(members[0])
            if axes is None:
                for m in members:
                    self._step_solo_one(m)
                return
            try:
                carry = rowpack.pack_rows(
                    [m["carry"] for m in members],
                    [m.get("row", 0) for m in members], axes, bs)
            except rowpack.AmbiguousPackAxisError:
                for m in members:
                    self._step_solo_one(m)
                return
            enc = pipe.step_carry_pack_enc([m["enc"] for m in members], bs)
            grp = {"axes": axes, "n": n, "enc": enc}
        i_rows = [m["i"] for m in members]
        gs_rows = [float(m["gs"]) for m in members]
        i_rows += [i_rows[-1]] * (bs - n)
        gs_rows += [gs_rows[-1]] * (bs - n)
        new_carry = pipe.step_carry_step_rows(carry, i_rows, enc, gs_rows, self.steps)
        # the step may grow the carry (buffers and scheduler history appear
        # at the first step): the group's plan follows its new structure
        axes = self._step_axes({"carry": new_carry, "enc": enc})
        if axes is None:
            raise rowpack.AmbiguousPackAxisError(
                "a packed step left a carry whose rows cannot be told apart")
        grp["axes"] = axes
        for r, m in enumerate(members):
            m["carry"] = new_carry
            m["row"] = r
            m["pack"] = grp
            m["i"] += 1
        stats["dispatches"] += 1
        stats["packed_rows"] += n
        stats["rows_capacity"] += bs

    def step_plan(self, works: List[Dict[str, Any]]) -> List[List[int]]:
        """The dispatches of one round, as lists of indices into ``works``:
        cohort members whose next step shares a signature
        (`step_signature`: same phase / buffers / shallow flag / scheduler
        history) form one group, in cohort (EDF) order, at most
        ``batch_size`` rows each; works with no signature (unsupported
        configs) come first, one a dispatch.  Over n ranks rank 0 plans
        and every rank runs the plan (serve/ranks.py)."""
        bs = self.batch_size
        groups: List[List[int]] = []
        solos: List[List[int]] = []
        open_group: Dict[Any, List[int]] = {}
        for i, w in enumerate(works):
            sig = self.step_signature(w)
            if sig is None:
                solos.append([i])
                continue
            g = open_group.get(sig)
            if g is None or len(g) >= bs:
                g = []
                open_group[sig] = g
                groups.append(g)
            g.append(i)
        return solos + groups

    def step_run(self, works: List[Dict[str, Any]],
                 plan: Optional[List[List[int]]] = None) -> None:
        """Advance each work by exactly ONE denoise step (its own step
        index -- cohort members may sit at different timesteps), and wait
        for the cohort's device work so the step batcher's calibrated
        per-step service time is honest.

        Each group of ``plan`` (default `step_plan`) advances in ONE
        padded evaluation, each member's real row on its own batch row,
        bit-identical to its solo step; a group of one and ambiguous
        carry layouts run the solo per-slot dispatch.  `step_pack_stats`
        tallies this call's dispatches / real rows / row capacity for the
        server's pack-efficiency counters."""
        self.step_pack_stats = {"dispatches": 0, "packed_rows": 0,
                                "rows_capacity": 0}
        if plan is None:
            plan = self.step_plan(works)
        with self._on_card():
            for group in plan:
                members = [works[i] for i in group]
                if len(members) == 1:
                    self._step_solo_one(members[0])
                else:
                    self._step_dispatch_packed(members)
            self._sync()

    def step_done(self, work: Dict[str, Any]) -> bool:
        return work["i"] >= self.steps

    def step_finish(self, work: Dict[str, Any]):
        """Decode the finished carry to the request's np image -- the
        work's own packed row (row 0 in the solo layout).  A packed carry
        is shared with the group's other members: dropping this work's
        reference is its release."""
        stages = self.prepare_stages()
        with self._on_card():
            latent = self.pipeline.step_carry_latent(work["carry"])
            images = stages.decode(latent)
        row = work.get("row", 0)
        for k in ("pack", "carry", "enc"):
            work.pop(k, None)
        return list(images)[row]

    def step_abort(self, work: Dict[str, Any]) -> None:
        """Release a work's device buffers without decoding (failed or
        stopped mid-denoise).  Cached embeddings stay with the prompt
        cache; a packed (shared) carry is only dereferenced."""
        for k in ("pack", "carry", "enc"):
            work.pop(k, None)

    def step_park(self, work: Dict[str, Any]) -> None:
        """Preemption: pull the carry to HOST memory so the parked request
        stops holding device residency (the slot it frees goes to the
        preemptor).  A packed member first extracts back to its solo
        layout.  device->host->device is an exact byte round-trip, so the
        resumed denoise is bit-identical."""
        with self._on_card():
            self._step_ensure_solo(work)
            leaves, structure = rowpack.tree_flatten(work["carry"])
            work["parked_on"] = [leaf.device for leaf in leaves]
            work["carry"] = rowpack.tree_unflatten(structure, [leaf.cpu() for leaf in leaves])

    def step_resume(self, work: Dict[str, Any]) -> None:
        """Resume a parked carry: each leaf back where it lived (the
        scheduler's per-run scalars stay on the CPU, as the solo step
        keeps them), byte for byte."""
        devices = work.pop("parked_on", None)
        if devices is None:
            return
        with self._on_card():
            leaves, structure = rowpack.tree_flatten(work["carry"])
            work["carry"] = rowpack.tree_unflatten(
                structure, [leaf.to(d) for leaf, d in zip(leaves, devices)])
            self._sync()

    def step_export(self, work: Dict[str, Any]):
        """Carry migration (serve/migration.py): the request's denoise
        carry as HOST tensors for serialization -- the same device->host
        round-trip `step_park` makes, so an importing server resumes the
        identical bytes.  Returns ``(extra_meta, leaves)``: the
        executor-owned header fields (family, step index, and the carry's
        structure, which grows after the first step) and the flat leaf
        list; the work itself is left intact (the caller still releases
        it via `step_abort`).  A packed member exports its SOLO layout."""
        with self._on_card():
            self._step_ensure_solo(work)
            leaves, structure = rowpack.tree_flatten(work["carry"])
            leaves = [leaf.cpu() for leaf in leaves]
        extra = {"family": type(self.pipeline).__name__,
                 "step": int(work["i"]),
                 "carry_structure": repr(structure)}
        return extra, leaves

    def _carry_template(self, work: Dict[str, Any], step: int, structure: str):
        """A carry of the structure a step-``step`` carry of this request
        has: the fresh carry, or (when its structure differs from the
        snapshot's) the carry after one step -- buffers and scheduler
        history appear at the first step and keep their shapes after."""
        carry = work["carry"]
        if step == 0 or repr(rowpack.tree_flatten(carry)[1]) == structure:
            return carry
        with self._on_card():
            return self.pipeline.step_carry_step(carry, 0, work["enc"], work["gs"],
                                                 self.steps)

    def step_import(self, meta: Dict[str, Any], leaves, prompt: str,
                    negative_prompt: str, seed: int,
                    guidance_scale: float) -> Dict[str, Any]:
        """Adopt an exported carry: rebuild the request's work via
        `step_begin` (re-encoded embeddings; encode is a pure function of
        the prompt, so they are bit-identical to the exporter's), validate
        every snapshot leaf against a template carry's shape and dtype,
        then graft the snapshot leaves in and resume at the exported step
        index.  Structure drift rejects TYPED (`MigrationRejectedError`):
        resuming a mismatched carry would be silent corruption."""
        family = type(self.pipeline).__name__
        if meta.get("family") != family:
            raise MigrationRejectedError(
                f"carry snapshot family {meta.get('family')!r} cannot "
                f"import into a {family} executor")
        step = int(meta["step"])
        if not (0 <= step <= self.steps):
            raise MigrationRejectedError(
                f"carry snapshot step {step} out of range for a "
                f"{self.steps}-step executor")
        work = self.step_begin(prompt, negative_prompt, seed, guidance_scale)
        template = self._carry_template(work, step, str(meta.get("carry_structure")))
        tmpl_leaves, structure = rowpack.tree_flatten(template)
        if meta.get("carry_structure") not in (None, repr(structure)):
            self.step_abort(work)
            raise MigrationRejectedError(
                "carry snapshot structure does not match this executor's carry "
                f"at step {step}")
        if len(leaves) != len(tmpl_leaves):
            self.step_abort(work)
            raise MigrationRejectedError(
                f"carry snapshot has {len(leaves)} leaves; this "
                f"executor's carry has {len(tmpl_leaves)}")
        for i, (got, want) in enumerate(zip(leaves, tmpl_leaves)):
            if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
                self.step_abort(work)
                raise MigrationRejectedError(
                    f"carry snapshot leaf {i} is {tuple(got.shape)}/{got.dtype}; "
                    f"this executor's carry wants {tuple(want.shape)}/{want.dtype}")
        with self._on_card():
            work["carry"] = rowpack.tree_unflatten(
                structure, [torch.as_tensor(leaf).to(want.device)
                            for leaf, want in zip(leaves, tmpl_leaves)])
            self._sync()
        work["i"] = step
        return work

    def step_preview(self, work: Dict[str, Any], max_size: int = 64):
        """Cheap intermediate preview: the request's CURRENT latent,
        host-side -- first three latent channels min-max normalized and
        stride-downsampled to at most ``max_size`` per edge.  No model, no
        VAE: previews cost O(latent bytes) of copy, never a denoise."""
        with self._on_card():
            lat = self.pipeline.step_carry_latent(work["carry"])[work.get("row", 0)]
            lat = lat.float().cpu().numpy()
        rgb = (lat[..., :3] if lat.shape[-1] >= 3
               else np.repeat(lat[..., :1], 3, axis=-1))
        lo, hi = float(rgb.min()), float(rgb.max())
        rgb = (rgb - lo) / ((hi - lo) or 1.0)
        stride = max(1, -(-max(rgb.shape[0], rgb.shape[1]) // int(max_size)))
        return rgb[::stride, ::stride].astype(np.float32)


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


# One build at a time in the process.  Several servers may share one card
# (the replicas of serve/fleet.py, each with its own scheduler thread), and
# a build returns the caching allocator's free blocks to the card and
# captures CUDA graphs: two builds at once would free blocks under another
# build's capture (the allocator refuses to synchronise while one is under
# way) and interleave two captures' private pools.  A dispatch on another
# server's thread keeps running while a build holds the lock: a capture in
# ``thread_local`` mode on its own stream neither waits for it nor is
# invalidated by it.
card_build_lock = threading.Lock()


def pipeline_executor_factory(
    build_pipeline: Callable[[ExecKey], Any],
    fault_plan: Optional[FaultPlan] = None,
) -> Callable[[ExecKey], PipelineExecutor]:
    """Executor factory for `InferenceServer` from a pipeline build function.

    ``build_pipeline(key)`` constructs the pipeline for a bucket -- e.g. a
    DistriConfig at (key.height, key.width) with
    do_classifier_free_guidance=key.cfg and the serving batch width, then
    ``from_params`` / ``from_pretrained`` with key.scheduler.  Over n ranks
    it makes its DistriConfig anew at each build: after a rebuild of the
    data groups (serve/ranks.py) the next build must take the new ones.  The factory
    forces the key's policy (`apply_key_policy`) and runs `prepare`, which
    captures the denoiser's CUDA graphs, so cache misses pay the full cost
    HERE, off the per-request path, and hands back a ready executor with
    its stages built (`PipelineExecutor.prepare_stages`).
    Before the build it returns the caching allocator's free blocks to the
    card (``torch.cuda.empty_cache``), so a rebuild after an OOM starts
    from what the failed call gave back.  Builds hold `card_build_lock`,
    so replicas sharing a card build one at a time.  ``fault_plan``
    injects at sites ``"executor.build"`` / ``"executor.execute"``.
    """

    def factory(key: ExecKey) -> PipelineExecutor:
        if fault_plan is not None:
            fault_plan.check("executor.build", key=key)
        with card_build_lock:
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            pipe = build_pipeline(key)
            apply_key_policy(pipe, key)
            pipe.prepare(key.steps)
            ex = PipelineExecutor(pipe, key.steps, key=key,
                                  fault_plan=fault_plan)
            # the stages (and any capture they make) are built here, on
            # the building thread, before a stage worker can run the
            # executor
            ex.prepare_stages()
        return ex

    return factory
