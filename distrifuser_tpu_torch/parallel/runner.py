"""The denoising loop: one device, or one rank of patch or tensor parallelism.

Counterpart of distrifuser_tpu/parallel/runner.py (``_check_geometry``,
``DenoiseRunner._unet_local``, ``_naive_patch_unet``, ``_make_step``,
``_device_loop``, ``generate``, ``prepare``, ``comm_volume_report``,
``make_runner``).  The JAX package compiles the whole loop into one
program; here the loop is Python, the same on every rank, and each UNet
evaluation runs eagerly or, under ``use_compiled_step`` (the config's
``use_cuda_graph``), as the replay of a graph captured once per phase
(parallel/graphs.py):

* every rank holds the whole latent, runs the replicated scheduler in
  float32 and, except under tensor parallelism, computes the text KV of
  every cross-attention once per generation;
* at one rank (or a CFG split with one patch per branch) the UNet runs
  dense (``DenseDispatch``);
* under displaced patch parallelism it runs on this rank's rows
  (``PatchDispatch``): steps 0..``warmup_steps`` are synchronous (fresh
  activations, blocking exchanges) and seed the per-layer buffers; the
  steps after them are stale (``mode``): each layer uses the previous
  step's peer activations and refreshes them asynchronously.
  ``full_sync`` runs every step synchronously.  The rows are gathered over
  the ``batch_group`` after every step;
* under naive patch parallelism the unmodified dense UNet runs on this
  rank's rows or columns (``split_scheme``; ``alternate`` takes rows on
  even steps and columns on odd ones), gathered after every step, with no
  state;
* under tensor parallelism every rank holds the whole latent and its
  shard of the heads and channels (models/unet_tp.py);
* the CFG branches fold into the batch, or under ``cfg_split`` each rank
  runs its branch and the guided output gathers them over the
  ``split_group``;
* under data parallelism (``dp_degree`` > 1) every rank holds the whole
  batch, but its image group evaluates the UNet on its share only (rows
  ``dp_idx * B/dp ..``, as the JAX package splits the batch over its
  ``dp`` axis); the guided outputs gather over the ``dp_group`` before
  the scheduler step, so the scheduler, the callback and the result see
  the whole batch in order on every rank.

The displaced path runs the JAX package's comm knobs (parallel/context.py:
refresh compression, PCPP partial refresh, the batched flush) and ring
attention (``attn_impl="ring"``).  Under the step cache
(parallel/stepcache.py) the steps after the warmup run the shallow-first
cadence: ``_phases`` lists a "shallow" evaluation for each shallow step,
which resumes from the deep feature the last full step kept.  The
explicit-carry API (``stepwise_carry_init`` / ``stepwise_carry_step`` /
``stepwise_carry_latent`` / ``stepwise_carry_signature``) runs the same
per-step evaluations one step at a time on a carry the caller holds, so
carries interleaved step by step give the latents of contiguous runs.  Its
rows variants (``stepwise_rows_supported`` / ``stepwise_carry_rows_axes``
/ ``stepwise_carry_step_rows``, shared with the transformer runners
through ``StepLoop``) advance a carry whose batch rows belong to different
requests, each at its own step index and guidance scale, in one
evaluation: the serve plane's packed cohort step (serve/executors.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models.unet import (DenseDispatch, PatchDispatch, UNetConfig,
                           precompute_text_kv, unet_forward)
from ..schedulers import BaseScheduler
from ..utils.config import DistriConfig
from . import rowpack
from .collectives import gather_batch, gather_cols, gather_rows, stages_through_host
from .context import PHASE_STALE, PHASE_SYNC, PatchContext
from .graphs import StepGraphs
from .guidance import branch_select, combine_guidance
from .stepcache import STEPCACHE_KEY, is_shallow_at

ROW, COL = "row", "col"  # the UNet evaluations of naive patch parallelism
# a shallow step of the step cache: the steady phase's body (stale, or sync
# where every step is synchronous) without the deep subtree
PHASE_SHALLOW = "shallow"
# buffer kinds that never touch the wire: the deep cache, residual own rows
WIRE_FREE = ("stepcache", "local")


def _check_geometry(cfg: DistriConfig, ucfg: UNetConfig) -> None:
    """Patches must stay whole rows (columns) down to the deepest UNet
    level."""
    if not cfg.is_sp:
        return
    depth = len(ucfg.block_out_channels) - 1  # number of downsamples
    n = cfg.n_device_per_batch
    naive = cfg.parallelism == "naive_patch"
    if not naive or cfg.split_scheme in ("row", "alternate"):
        if cfg.latent_height % (n * (1 << depth)):
            raise ValueError(
                f"latent height {cfg.latent_height} must be divisible by "
                f"n_devices*2^depth = {n * (1 << depth)} for row patching"
            )
    if naive and cfg.split_scheme in ("col", "alternate"):
        if cfg.latent_width % (n * (1 << depth)):
            raise ValueError(
                f"latent width {cfg.latent_width} must be divisible by "
                f"n_devices*2^depth = {n * (1 << depth)} for column patching"
            )


def check_graph_transport(cfg: DistriConfig) -> None:
    """Refuse ``use_cuda_graph`` where a collective stages CUDA payloads
    through the host (ranks that share a card in a gloo group)."""
    if (cfg.use_cuda_graph and cfg.world_size > 1
            and stages_through_host(cfg.device, cfg.batch_group)):
        raise ValueError(
            "use_cuda_graph=True with ranks that share a card: their gloo "
            "group stages every CUDA payload through pinned host memory and "
            "synchronises the host at each exchange, which a CUDA graph "
            "cannot hold; pass use_cuda_graph=False (or give each rank its "
            "own card over NCCL)"
        )


class StepLoop:
    """What the denoising loops of the model families share (the UNet's
    ``DenoiseRunner``, the transformers' ``TransformerRunner`` of
    parallel/dit_sp.py):
    a parameter tree whose replacement drops the captured graphs, this image
    group's share of the batch, a step's model input, the schedule's device
    tensors and the guided scheduler step.  Needs ``cfg``, ``scheduler``,
    ``graphs`` and ``_schedule`` on the instance."""

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, tree) -> None:
        self._params = tree
        self.graphs.clear()  # the graphs read the old tree's addresses

    def _my_images(self, t, dim: int = 0):
        """This image group's share of the batch dim ``dim`` of ``t``: all of
        it at dp_degree 1."""
        dp = self.cfg.dp_degree
        if dp == 1:
            return t
        if t.shape[dim] % dp:
            raise ValueError(f"batch_size {t.shape[dim]} not divisible by dp_degree {dp}")
        return t.chunk(dp, dim=dim)[self.cfg.dp_idx()]

    def _step_tensors(self, num_steps: int):
        """(timesteps, step indices) of the ``num_steps`` schedule on the
        device, made once: a step copies its entries into a graph's inputs
        with no host-to-device copy."""
        if num_steps not in self._schedule:
            dev = self.cfg.device
            self._schedule[num_steps] = (
                self.scheduler.timesteps().to(dev),
                torch.arange(num_steps, device=dev))
        return self._schedule[num_steps]

    def _model_input(self, x, i):
        """The model's input at step ``i``: this image group's latents (or
        tokens), scaled, the CFG branches folded into the batch unless
        split."""
        x_in = self.scheduler.scale_model_input(self._my_images(x), i)
        if self.cfg.do_classifier_free_guidance and not self.cfg.cfg_split:
            x_in = torch.cat([x_in, x_in], dim=0)
        return x_in

    def _stepwise_phase(self, i: int, start_step: int, end_step: int) -> Tuple[str, bool]:
        """(phase, shallow) of step ``i`` of a run over ``start_step..
        end_step-1`` (JAX ``_stepwise_phase``): the synchronous steps are
        the first ``warmup_steps + 1`` that run (every step where the patch
        path has one phase: full_sync, one rank, no patches), and under the
        step cache the steps after them follow the shallow-first cadence
        (the UNet's runner and the transformers' alike)."""
        cfg = self.cfg
        sc = cfg.step_cache_enabled
        one_phase = (cfg.parallelism != "patch" or cfg.mode == "full_sync"
                     or not cfg.is_sp)
        n_sync = (end_step - start_step if one_phase and not sc
                  else min(cfg.warmup_steps + 1, end_step - start_step))
        phase = PHASE_SYNC if one_phase or i < start_step + n_sync else PHASE_STALE
        shallow = sc and is_shallow_at(i, start_step + n_sync, cfg.step_cache_interval)
        return phase, shallow

    def _guided_step(self, x, out, i, sstate, gs):
        """The CFG combine of the model's output ``out`` (this image
        group's; under data parallelism every group's gathered in batch
        order), then the scheduler's step ``i`` in float32: (x, scheduler
        state).  ``i`` may be one index a row and ``gs`` one scale a row
        (shaped to broadcast along x's batch axis): the packed step."""
        guided = combine_guidance(self.cfg, out, gs, x.shape[0] // self.cfg.dp_degree)
        if self.cfg.dp_degree > 1:
            guided = gather_batch(guided, self.cfg.dp_group)
        return self.scheduler.step(x, guided.float(), i, sstate)

    # -- the explicit-carry API's packed rows (serve/executors.py) ---------
    #
    # A subclass gives ``_family`` (the signature's tag), ``_cond_of(*args)``
    # (the evaluation's conditioning from the stepwise call's conditioning
    # arguments) and ``_evaluate_at(x_in, t, cond, key, state, step)`` (one
    # eager evaluation of ``key``).  A carry is ``(x, buffers, scheduler
    # state)``; every tensor in it holds the batch at axis 0 (the CFG
    # branches of the buffers folded branch-major), 0-dim leaves are
    # per-run scheduler scalars.

    _family = "model"

    def stepwise_rows_supported(self) -> bool:
        """Whether a packed step (one step index and guidance scale a row)
        gives each row its solo step's bits (JAX
        ``stepwise_rows_supported``): not under data parallelism (the
        per-row index does not split with the batch), the partial-refresh
        rotation or lossy refresh compression (per-tensor scales couple
        rows), naive patch's alternate scheme, nor under
        ``use_cuda_graph`` (a replay's timestep is one scalar; the serve
        plane's step mode runs eagerly)."""
        cfg = self.cfg
        return (cfg.dp_degree == 1
                and cfg.refresh_fraction >= 1
                and cfg.comm_compress == "none"
                and not cfg.use_compiled_step
                and not (cfg.parallelism == "naive_patch"
                         and cfg.split_scheme == "alternate"))

    def stepwise_carry_signature(self, carry, i: int, num_steps: int):
        """Which evaluation advancing ``carry`` by step ``i`` runs (JAX
        ``stepwise_carry_signature``): carries of one signature run the
        same per-step evaluation and may pack into one dispatch's batch
        rows when their structures agree (the serve executor also keys
        its groups by the carry's structure: DPM++ 2M's state holds no
        history before its first step)."""
        phase, shallow = self._stepwise_phase(i, 0, num_steps)
        return (self._family, phase, carry[1] is not None, shallow, num_steps)

    def stepwise_carry_rows_axes(self, carry, num_steps: int):
        """The per-leaf packing plan (parallel/rowpack.py) of this
        carry's structure, from its leaf shapes at widths w and 2w."""
        w = carry[0].shape[0]
        leaves, structure = rowpack.tree_flatten(carry)

        def shapes(k):
            return rowpack.tree_unflatten(structure, [
                torch.empty((leaf.shape[0] * k,) + tuple(leaf.shape[1:])
                            if leaf.dim() else (), device="meta")
                for leaf in leaves])

        for leaf in leaves:
            if leaf.dim() and leaf.shape[0] % w:
                raise rowpack.AmbiguousPackAxisError(
                    f"carry leaf {tuple(leaf.shape)} does not hold the batch of "
                    f"{w} at axis 0")
        return rowpack.axes_from_shapes(shapes(1), shapes(2))

    @torch.inference_mode()
    def stepwise_carry_step_rows(self, carry, i_rows, *args):
        """Advance a PACKED carry: row ``r`` moves by exactly step
        ``i_rows[r]`` at guidance ``gs_rows[r]`` (JAX
        ``stepwise_carry_step_rows``); ``args`` are the stepwise step's
        conditioning arguments, then ``gs_rows`` and ``num_steps``.  Every
        row must share one signature (`stepwise_carry_signature`).  The
        evaluation is the solo step's, at the same width, with the
        timestep, the scheduler's coefficients and the guidance scale
        taken a row each, so a row gets its solo step's bits."""
        *cond_args, gs_rows, num_steps = args
        x, state, sstate = carry
        rows = [int(i) for i in i_rows]
        if len(rows) != x.shape[0] or len(gs_rows) != x.shape[0]:
            raise ValueError(f"{len(rows)} step indices and {len(gs_rows)} scales "
                             f"for a carry of {x.shape[0]} rows")
        sigs = {self.stepwise_carry_signature(carry, i, num_steps) for i in rows}
        if len(sigs) != 1:
            raise ValueError(f"packed rows span {len(sigs)} step signatures: {sigs}")
        if self.cfg.use_compiled_step:
            raise ValueError("a packed step runs eagerly: set_stepwise(True) first")
        sched = self.scheduler
        if sched.num_inference_steps != num_steps:
            sched.set_timesteps(num_steps)
        phase, shallow = self._stepwise_phase(rows[0], 0, num_steps)
        key = PHASE_SHALLOW if shallow else phase
        dev = self.cfg.device
        timesteps, steps = self._step_tensors(num_steps)
        idx = torch.tensor(rows, device=dev)
        x_in = self._model_input(x, rows)
        t = timesteps[idx]
        if self.cfg.do_classifier_free_guidance and not self.cfg.cfg_split:
            t = torch.cat([t, t])
        gs = torch.tensor([float(g) for g in gs_rows], dtype=torch.float32,
                          device=dev).reshape((-1,) + (1,) * (x.dim() - 1))
        out, state = self._evaluate_at(x_in, t, self._cond_of(*cond_args), key, state,
                                       steps[rows[0]])
        x, sstate = self._guided_step(x, out, rows, sstate, gs)
        return x, state, sstate


class DenoiseRunner(StepLoop):
    """Runs the denoising loop for one (config, UNet, scheduler).

    ``dispatch`` builds the dispatch of a dense evaluation from the text
    KV (tensor parallelism passes its own).  After ``generate``,
    ``phase_counts`` holds how many steps ran in each phase ("shallow" too
    under the step cache) and ``comm_volume_report()`` the elements of this
    rank's per-layer buffers.  Replacing ``params`` drops the captured
    graphs."""

    def __init__(self, distri_config: DistriConfig, unet_config: UNetConfig,
                 params, scheduler: BaseScheduler, dispatch=None):
        if distri_config.parallelism == "pipefusion":
            raise ValueError(
                "pipefusion is a DiT strategy (parallel/pipefusion.py); the "
                "UNet's heterogeneous stages cannot pipeline — use "
                "parallelism='patch' here"
            )
        if distri_config.attn_impl in ("ulysses", "usp"):
            raise ValueError(
                f"attn_impl={distri_config.attn_impl!r} is a DiT strategy "
                "(parallel/dit_sp.py): head counts vary per UNet level, so "
                "the all-to-all head shard does not apply — use 'gather' or "
                "'ring' here"
            )
        n_levels = len(unet_config.block_out_channels)
        if distri_config.step_cache_enabled and not (
                1 <= distri_config.step_cache_depth < n_levels):
            raise ValueError(
                f"step_cache_depth={distri_config.step_cache_depth} must be in "
                f"[1, {n_levels - 1}] for this {n_levels}-level UNet (at least "
                "one level must stay shallow)"
            )
        _check_geometry(distri_config, unet_config)
        check_graph_transport(distri_config)
        self.cfg = distri_config
        self.ucfg = unet_config
        self.scheduler = scheduler
        self.dispatch = dispatch or (lambda text_kv: DenseDispatch(text_kv=text_kv))
        self.graphs = StepGraphs(distri_config.device)
        self.params = params
        self.phase_counts: Dict[str, int] = {}
        # what the evaluations of each phase exchanged, by buffer: (kind,
        # elements, wire bytes), for comm_volume_report
        self._kinds: Dict[str, str] = {}
        self._phase_buffers: Dict[str, Dict[str, Tuple[str, int, int]]] = {}
        # the synchronous step's buffers by name: comm_volume_report's
        self._buffer_kinds: Dict[str, str] = {}
        self._buffer_numel: Dict[str, int] = {}
        self._buffers_reported = False
        self._schedule: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def _cache_depth(self) -> int:
        cfg = self.cfg
        return cfg.step_cache_depth if cfg.step_cache_enabled else 0

    def _unet_local(self, x_in, t, my_enc, my_added, text_kv, phase, state, step=None):
        """One UNet evaluation on this rank, ``phase`` one of ``_phases``
        (``step`` the absolute step index, which a partial refresh rotates
        by): (the whole output of this rank's branch batch, the next step's
        buffers)."""
        cfg = self.cfg
        if cfg.parallelism == "naive_patch" and cfg.is_sp:
            return self._naive_patch_unet(x_in, t, my_enc, my_added, text_kv, phase), state
        cd = self._cache_depth
        shallow = phase == PHASE_SHALLOW
        if not cfg.is_sp:
            if not cd:
                out = unet_forward(self.params, self.ucfg, x_in, t, my_enc,
                                   dispatch=self.dispatch(text_kv), added_cond=my_added)
                self._record(phase, state, {}, {}, set())
                return out, state
            out, deep = unet_forward(
                self.params, self.ucfg, x_in, t, my_enc, dispatch=self.dispatch(text_kv),
                added_cond=my_added, cache_depth=cd,
                deep_cache=state[STEPCACHE_KEY] if shallow else None)
            if deep is not None:
                state = {STEPCACHE_KEY: deep}
            self._record(phase, state, {STEPCACHE_KEY: "stepcache"}, {},
                         {STEPCACHE_KEY} if shallow else set())
            return out, state
        if shallow:  # the steady phase's body, without the deep subtree
            one_phase = cfg.mode == "full_sync"
            ctx_phase = PHASE_SYNC if one_phase else PHASE_STALE
        else:
            ctx_phase = phase
        ctx = PatchContext(n=cfg.n_device_per_batch, mode=cfg.mode, phase=ctx_phase,
                           group=cfg.batch_group, split_idx=cfg.split_idx(),
                           attn_impl=cfg.attn_impl, batch_comm=cfg.comm_batch,
                           compress=cfg.comm_compress,
                           refresh_fraction=cfg.refresh_fraction, step=step,
                           state_in=state, text_kv=text_kv)
        dispatch = PatchDispatch(ctx)
        if cd:
            out_local, deep = unet_forward(
                self.params, self.ucfg, x_in, t, my_enc, dispatch=dispatch,
                added_cond=my_added, cache_depth=cd,
                deep_cache=ctx.stale(STEPCACHE_KEY) if shallow else None)
            if deep is not None:  # a full step refreshes the cache
                ctx.emit(STEPCACHE_KEY, deep, "stepcache")
        else:
            out_local = unet_forward(self.params, self.ucfg, x_in, t, my_enc,
                                     dispatch=dispatch, added_cond=my_added)
        ctx.flush()
        if cd:  # the layers a shallow step skips pass their buffers on
            ctx.carry_unconsumed()
        state = ctx.finish()
        self._record(phase, state, ctx.kinds, ctx.wire, ctx.carried)
        return gather_rows(out_local, cfg.batch_group), state

    def _record(self, phase, state, kinds, wire, carried) -> None:
        """Keep, for ``comm_volume_report``, what an evaluation of ``phase``
        freshly exchanged: each buffer of ``state`` it did not carry, with
        its kind, elements and wire bytes (the bytes its exchange put on
        the wire, 0 for the wire-free kinds, else the buffer's bytes)."""
        self._kinds.update(kinds)
        fresh = {}
        for name, buf in (state or {}).items():
            if name in carried:
                continue
            kind = self._kinds.get(name, "other")
            numel = buf.numel()
            default = 0 if kind in WIRE_FREE else numel * buf.element_size()
            fresh[name] = (kind, numel, wire.get(name, default))
        self._phase_buffers[phase] = fresh
        if phase == PHASE_SYNC and self.cfg.is_sp:
            self._buffer_kinds = {name: entry[0] for name, entry in fresh.items()}
            self._buffer_numel = {name: entry[1] for name, entry in fresh.items()}

    def _naive_patch_unet(self, x_in, t, my_enc, my_added, text_kv, scheme):
        """Naive patch parallelism (JAX ``_naive_patch_unet``): this rank's
        rows (``scheme`` ROW) or columns (COL) of ``x_in`` through the
        unmodified dense UNet, gathered into the whole output."""
        cfg = self.cfg
        dim = 1 if scheme == ROW else 2
        xs = x_in.chunk(cfg.n_device_per_batch, dim=dim)[cfg.split_idx()]
        y = unet_forward(self.params, self.ucfg, xs, t, my_enc,
                         dispatch=self.dispatch(text_kv), added_cond=my_added)
        gather = gather_rows if scheme == ROW else gather_cols
        return gather(y, cfg.batch_group)

    def _phases(self, end: int, start: int = 0) -> List[str]:
        """The UNet evaluation of each of the steps ``start..end-1``:
        PHASE_SYNC, PHASE_STALE or PHASE_SHALLOW, or ROW or COL under naive
        patch parallelism (``alternate`` by the absolute step's parity); one
        graph each.  Under displaced patch parallelism the synchronous steps
        are counted from ``start``: the first ``warmup_steps + 1`` steps
        that run (the reference counts ``counter <= warmup_steps`` as
        synchronous), so a run that starts mid-schedule (img2img, the
        second stage of a handoff) seeds its own stale buffers."""
        cfg = self.cfg
        if cfg.parallelism == "naive_patch" and cfg.is_sp:
            scheme = {"row": [ROW], "col": [COL], "alternate": [ROW, COL]}[cfg.split_scheme]
            return [scheme[i % len(scheme)] for i in range(start, end)]
        keys = []
        for i in range(start, end):
            phase, shallow = self._stepwise_phase(i, start, end)
            keys.append(PHASE_SHALLOW if shallow else phase)
        return keys

    def _conditioning(self, prompt_embeds, added_cond):
        """(this rank's embeddings, added conditioning, text KV) on this
        rank's device."""
        cfg = self.cfg
        dev = cfg.device
        prompt_embeds = torch.as_tensor(prompt_embeds).to(dev, cfg.dtype)
        added = None
        if added_cond is not None:
            added = {k: torch.as_tensor(v).to(dev) for k, v in added_cond.items()}
            if "text_embeds" in added:
                added["text_embeds"] = added["text_embeds"].to(cfg.dtype)
            if "time_ids" in added:
                added["time_ids"] = added["time_ids"].float()
        # this image group's images of the branch-major [n_br, B, ...] inputs
        prompt_embeds = self._my_images(prompt_embeds, dim=1)
        if added is not None:
            added = {k: self._my_images(v, dim=1) for k, v in added.items()}
        my_enc, my_added, _ = branch_select(cfg, prompt_embeds, added)
        # tensor parallelism recomputes the text KV with its sharded kernels
        # at every step, as the reference's TP attention does (no cache)
        text_kv = ({} if cfg.parallelism == "tensor"
                   else precompute_text_kv(self.params, my_enc))
        return my_enc, my_added, text_kv

    def _inputs(self, latents, prompt_embeds, added_cond, guidance_scale):
        """The generation's tensors on this rank's device: (latent float32,
        this rank's embeddings, added conditioning, text KV, guidance
        scale)."""
        dev = self.cfg.device
        my_enc, my_added, text_kv = self._conditioning(prompt_embeds, added_cond)
        gs = torch.tensor(guidance_scale, dtype=torch.float32, device=dev)
        x = torch.as_tensor(latents).to(dev, torch.float32)
        return x, my_enc, my_added, text_kv, gs

    def _begin_graphs(self, x, my_enc, my_added, text_kv, phases, start=0) -> None:
        """Capture (on a card) the graphs of ``phases`` for this
        generation's shape, if not yet captured, and load its
        conditioning into their static inputs; ``start`` is the first
        step that runs."""
        check_graph_transport(self.cfg)
        n = self.scheduler.num_inference_steps
        timesteps, steps = self._step_tensors(n)
        stateful = [p for p in (PHASE_STALE, PHASE_SHALLOW) if p in phases]
        self.graphs.begin(
            tuple(x.shape), self._model_input(x, start), timesteps[start], my_enc,
            my_added, text_kv, list(dict.fromkeys(phases)), stateful, self._evaluate,
            step=steps[start])

    def _evaluate(self, phase, inputs, state):
        """``_unet_local`` on a graph's static inputs."""
        return self._unet_local(inputs.x_in, inputs.t, inputs.enc, inputs.added,
                                inputs.text_kv, phase, state, step=inputs.step)

    def _advance(self, x, i, phase, state, sstate, cond, gs, graphed):
        """Step ``i`` of the current schedule: the UNet evaluation ``phase``
        (a graph replay when ``graphed``), the guidance and the scheduler
        step.  Returns ``(x, buffers, scheduler state)``; a replay's buffers
        are the graph's own."""
        my_enc, my_added, text_kv = cond
        timesteps, steps = self._step_tensors(self.scheduler.num_inference_steps)
        x_in = self._model_input(x, i)
        if graphed:
            graph = self.graphs[phase]
            graph.inputs.set_step(x_in, timesteps[i], steps[i])
            if graph.stateful:
                graph.load_state(state)
            out, state = graph.replay(self._evaluate)
        else:
            out, state = self._unet_local(x_in, timesteps[i], my_enc, my_added,
                                          text_kv, phase, state, step=steps[i])
        x, sstate = self._guided_step(x, out, i, sstate, gs)
        return x, state, sstate

    @torch.inference_mode()
    def prepare(self, latents, prompt_embeds, *, num_inference_steps: int = 50,
                added_cond: Optional[Dict[str, Any]] = None) -> None:
        """Capture, ahead of the first call, the graphs a generation of
        these shapes and ``num_inference_steps`` steps replays (JAX
        ``DenoiseRunner.prepare``); the values of the inputs do not matter.
        Without ``use_cuda_graph`` there is nothing to prepare."""
        if not self.cfg.use_compiled_step:
            return
        self.scheduler.set_timesteps(num_inference_steps)
        x, my_enc, my_added, text_kv, _ = self._inputs(latents, prompt_embeds,
                                                       added_cond, 1.0)
        self._begin_graphs(x, my_enc, my_added, text_kv,
                           self._phases(num_inference_steps))

    def _count(self, phase) -> None:
        key = phase if phase in (PHASE_STALE, PHASE_SHALLOW) else PHASE_SYNC
        self.phase_counts[key] += 1

    def _reset_counts(self) -> None:
        self.phase_counts = {PHASE_SYNC: 0, PHASE_STALE: 0}
        if self.cfg.step_cache_enabled:
            self.phase_counts[PHASE_SHALLOW] = 0

    @torch.inference_mode()
    def generate(self, latents, prompt_embeds, *, guidance_scale: float = 5.0,
                 num_inference_steps: int = 50,
                 added_cond: Optional[Dict[str, Any]] = None,
                 start_step: int = 0, end_step: Optional[int] = None, callback=None):
        """Run the loop over steps ``start_step..end_step-1`` of the
        ``num_inference_steps``-step schedule (``end_step`` None: to the
        end).  ``latents``: [B, H/8, W/8, C] initial noise already scaled by
        ``scheduler.init_noise_sigma`` or, with ``start_step > 0``, a latent
        at that schedule point (img2img: ``scheduler.add_noise``; a handoff:
        the first stage's output); ``prompt_embeds``: [n_branches, B, L, C],
        branch 0 unconditional; every rank passes the same.  The
        scheduler's state (DPM++ 2M's history) starts fresh at
        ``start_step``.  ``callback(i, t, x)`` runs after every step with
        the absolute step index.  Returns the latent after ``end_step``,
        float32, the same on every rank.  Under ``verbose`` the runner's
        first generate prints the stale buffers' sizes
        (``comm_volume_report``), as the reference prints them when it
        creates them."""
        cfg, sched = self.cfg, self.scheduler
        end = num_inference_steps if end_step is None else end_step
        if not 0 <= start_step < num_inference_steps:
            raise ValueError(f"start_step {start_step} outside [0, {num_inference_steps})")
        if not start_step < end <= num_inference_steps:
            raise ValueError(f"end_step {end_step} outside ({start_step}, "
                             f"{num_inference_steps}]")
        sched.set_timesteps(num_inference_steps)
        x, my_enc, my_added, text_kv, gs = self._inputs(latents, prompt_embeds,
                                                        added_cond, guidance_scale)
        phases = self._phases(end, start_step)
        graphed = cfg.use_compiled_step
        if graphed:
            self._begin_graphs(x, my_enc, my_added, text_kv, phases, start_step)
        sstate = sched.init_state(x.shape)
        self._reset_counts()
        state = None
        cond = (my_enc, my_added, text_kv)
        for i, phase in enumerate(phases, start=start_step):
            x, state, sstate = self._advance(x, i, phase, state, sstate, cond, gs, graphed)
            self._count(phase)
            if callback is not None:
                callback(i, sched.timesteps()[i], x)
        if cfg.verbose and not self._buffers_reported:
            self._buffers_reported = True
            self.comm_volume_report()
        return x

    # -- the explicit-carry stepwise API ----------------------------------

    def stepwise_carry_init(self, latents, num_steps: int):
        """Start a denoise whose carry the caller holds: ``(x, buffers,
        scheduler state)``, what one step of ``generate`` hands to the
        next.  Carries advance one step at a time (``stepwise_carry_step``)
        and may interleave: each step runs the evaluation a contiguous run
        of that step runs."""
        self.scheduler.set_timesteps(num_steps)
        x = torch.as_tensor(latents).to(self.cfg.device, torch.float32)
        return x, None, self.scheduler.init_state(x.shape)

    @torch.inference_mode()
    def stepwise_carry_step(self, carry, i: int, enc, added, gs, num_steps: int):
        """Advance ``carry`` by exactly step ``i`` of a ``num_steps`` run and
        return the new carry; ``enc`` [n_branches, B, L, C] and ``added`` as
        ``generate`` takes them, ``gs`` the guidance scale.  The carry's
        buffers are consumed (a stale step writes into them).  Under
        ``use_cuda_graph`` the step replays the run's graphs and the new
        carry owns copies of the graph's buffers."""
        x, state, sstate = carry
        sched = self.scheduler
        if sched.num_inference_steps != num_steps:
            sched.set_timesteps(num_steps)
        phase, shallow = self._stepwise_phase(i, 0, num_steps)
        key = PHASE_SHALLOW if shallow else phase
        if self.cfg.parallelism == "naive_patch" and self.cfg.is_sp:
            key = self._phases(i + 1, i)[0]
        cond = self._conditioning(enc, added)
        gs = torch.as_tensor(gs, dtype=torch.float32).to(self.cfg.device)
        graphed = self.cfg.use_compiled_step
        if graphed:
            self._begin_graphs(x, *cond, self._phases(num_steps), i)
        x, state, sstate = self._advance(x, i, key, state, sstate, cond, gs, graphed)
        if graphed and state is not None:
            state = {k: v.clone() for k, v in state.items()}
        return x, state, sstate

    def stepwise_carry_latent(self, carry):
        """The carry's current latent [B, H/8, W/8, C] (not consumed)."""
        return carry[0]

    _family = "unet"

    def _cond_of(self, enc, added):
        return self._conditioning(enc, added)

    def _evaluate_at(self, x_in, t, cond, key, state, step):
        return self._unet_local(x_in, t, *cond, key, state, step=step)

    # -- observability ----------------------------------------------------

    def comm_volume_report(self, *, per_phase: bool = False):
        """Elements of this rank's per-layer stale buffers by layer kind
        ("conv2d" halos, "attn" KV, "gn" gathered moments, "stepcache" the
        deep feature, "local" residual own rows), as the JAX package's
        ``comm_volume_report`` counts them; read from the buffers the last
        ``generate`` seeded.  Empty when the image is not in displaced
        patches.  Under ``verbose`` it also prints them, as the JAX package
        does.

        ``per_phase=True`` gives ``{"phases": {phase: {kind: elements}},
        "bytes": {phase: {kind: wire bytes}}, "refresh_fraction": f}`` for
        the phases the configuration runs ("sync", "stale" where the patch
        path has two phases, "shallow" under the step cache), each counting
        only what one step of that phase freshly exchanges: buffers carried
        through are left out, the bytes are those on the wire (a compressed
        payload's 8-bit elements and float32 scales, a partial refresh's
        rows) and the "stepcache" and "local" kinds count none.  A phase
        that has not run raises, naming it."""
        cfg = self.cfg
        if per_phase:
            return self._comm_volume_per_phase()
        if not cfg.is_sp or cfg.parallelism != "patch":
            return {}
        if not self._buffer_numel:
            raise RuntimeError("comm_volume_report reads the buffers of the last "
                               "generate(); call generate() first")
        report: Dict[str, int] = {}
        for name, numel in self._buffer_numel.items():
            kind = self._buffer_kinds[name]
            report[kind] = report.get(kind, 0) + numel
        if cfg.verbose:
            total = sum(report.values())
            print(f"Stale-state buffers: {total / 1e6:.3f}M elements over "
                  f"{len(self._buffer_numel)} tensors per device.")
            for kind, numel in sorted(report.items()):
                print(f"  {kind}: {numel / 1e6:.3f}M elements")
        return report

    def _comm_volume_per_phase(self) -> Dict[str, Any]:
        cfg = self.cfg
        if cfg.parallelism != "patch":
            return {"phases": {}, "bytes": {}, "flops": None}
        one_phase = cfg.mode == "full_sync" or not cfg.is_sp
        wanted = [PHASE_SYNC] + ([] if one_phase else [PHASE_STALE])
        if cfg.step_cache_enabled:
            wanted.append(PHASE_SHALLOW)
        phases: Dict[str, Dict[str, int]] = {}
        nbytes: Dict[str, Dict[str, int]] = {}
        for phase in wanted:
            if phase not in self._phase_buffers:
                raise RuntimeError(
                    f"comm_volume_report(per_phase=True): no {phase!r} step has "
                    "run yet; it reads the buffers of the last generate(), whose "
                    f"schedule must reach a {phase!r} step")
            phases[phase], nbytes[phase] = {}, {}
            for kind, numel, wire in self._phase_buffers[phase].values():
                phases[phase][kind] = phases[phase].get(kind, 0) + numel
                nbytes[phase][kind] = nbytes[phase].get(kind, 0) + wire
        return {"phases": phases, "bytes": nbytes,
                "refresh_fraction": cfg.refresh_fraction,
                "flops": self._flop_estimate()}

    def _flop_estimate(self) -> Optional[Dict[str, float]]:
        """``{"full", "shallow", "shallow_ratio"}``: the floating-point
        operations of one steady full evaluation of this rank and of one
        shallow evaluation under the step cache (JAX ``_flop_estimate``);
        None with the cache off.  Counted by ``FlopCounterMode`` over the
        dense UNet on fake CPU tensors (``FakeTensorMode``: shapes, no
        memory) through the plain version of every op (a quantized kernel
        as a dense one of its shape): nothing executes, and the count is the
        same whichever kernel runs the work on the card.  The
        dense evaluation covers the image group's batch (both CFG
        branches) over the whole latent; under displaced patch parallelism
        every rank computes its rows of each conv and GEMM and its query
        rows of each attention, so a rank's count is that over the group's
        ``group_size`` ranks.  Convolutions, GEMMs and the attention's two
        products count (2 x multiply-adds), elementwise work does not,
        where the JAX package's count (XLA's cost analysis) has it too.
        The text KV is computed once a generation, outside the step."""
        cfg = self.cfg
        if not cfg.step_cache_enabled:
            return None
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils.flop_counter import FlopCounterMode

        from ..models.weights import _map_leaves

        ucfg, dtype = self.ucfg, cfg.dtype
        b = (cfg.batch_size // cfg.dp_degree) * (2 if cfg.do_classifier_free_guidance else 1)
        out: Dict[str, float] = {}
        with FakeTensorMode():  # CPU tensors of shapes alone: the plain ops
            params = _map_leaves(lambda leaf: torch.empty(leaf.shape, dtype=leaf.dtype),
                                 self.params)
            sample = torch.empty((b, cfg.latent_height, cfg.latent_width, ucfg.in_channels),
                                 dtype=dtype)
            enc = torch.empty((b, 77, ucfg.cross_attention_dim), dtype=dtype)
            added = None
            if ucfg.addition_embed_type == "text_time":
                pooled = (ucfg.projection_class_embeddings_input_dim
                          - 6 * ucfg.addition_time_embed_dim)
                added = {"text_embeds": torch.empty((b, pooled), dtype=dtype),
                         "time_ids": torch.empty((b, 6))}
            dispatch = self.dispatch(precompute_text_kv(params, enc))
            deep = None
            for name in ("full", "shallow"):
                with FlopCounterMode(display=False) as counter:
                    res = unet_forward(params, ucfg, sample, torch.zeros(()), enc,
                                       dispatch=dispatch, added_cond=added,
                                       cache_depth=self._cache_depth, deep_cache=deep)
                deep = res[1] if deep is None else deep
                out[name] = counter.get_total_flops() / cfg.group_size
        out["shallow_ratio"] = out["shallow"] / out["full"]
        return out


def make_runner(distri_config: DistriConfig, unet_config: UNetConfig, params,
                scheduler: BaseScheduler) -> DenoiseRunner:
    """The runner for ``distri_config.parallelism`` (JAX ``make_runner``):
    tensor parallelism across ranks shards the tree (this rank's heads and
    channels) and runs ``TPDispatch``; every other case the dense or patch
    dispatch of ``DenoiseRunner``."""
    cfg = distri_config
    if cfg.parallelism == "tensor" and cfg.n_device_per_batch > 1:
        from ..models.unet_tp import TPDispatch, head_dim_table, prepare_tp_params

        n, idx = cfg.n_device_per_batch, cfg.split_idx()
        tp_params = prepare_tp_params(params, unet_config, n, idx)
        dispatch = TPDispatch(n, idx, head_dim_table(unet_config), cfg.batch_group)
        return DenoiseRunner(cfg, unet_config, tp_params, scheduler,
                             dispatch=lambda text_kv: dispatch)
    return DenoiseRunner(cfg, unet_config, params, scheduler)
