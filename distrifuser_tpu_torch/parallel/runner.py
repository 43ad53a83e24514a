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
  ``split_group``.

The stepwise carry API is ROADMAP queue 1 item 11.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..models.unet import (DenseDispatch, PatchDispatch, UNetConfig,
                           precompute_text_kv, unet_forward)
from ..schedulers import BaseScheduler
from ..utils.config import DistriConfig
from .collectives import gather_cols, gather_rows, stages_through_host
from .context import PHASE_STALE, PHASE_SYNC, PatchContext
from .graphs import StepGraphs
from .guidance import branch_select, combine_guidance

ROW, COL = "row", "col"  # the UNet evaluations of naive patch parallelism


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


class DenoiseRunner:
    """Runs the denoising loop for one (config, UNet, scheduler).

    ``dispatch`` builds the dispatch of a dense evaluation from the text
    KV (tensor parallelism passes its own).  After ``generate``,
    ``phase_counts`` holds how many steps ran in each phase and
    ``comm_volume_report()`` the elements of this rank's per-layer
    buffers.  Replacing ``params`` drops the captured graphs."""

    def __init__(self, distri_config: DistriConfig, unet_config: UNetConfig,
                 params, scheduler: BaseScheduler, dispatch=None):
        if distri_config.parallelism == "pipefusion":
            raise ValueError(
                "pipefusion is a DiT strategy; the UNet's heterogeneous stages "
                "cannot pipeline — use parallelism='patch' here"
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
        self._buffer_kinds: Dict[str, str] = {}
        self._buffer_numel: Dict[str, int] = {}
        self._buffers_reported = False

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, tree) -> None:
        self._params = tree
        self.graphs.clear()  # the graphs read the old tree's addresses

    def _unet_local(self, x_in, t, my_enc, my_added, text_kv, phase, state):
        """One UNet evaluation on this rank, ``phase`` one of
        ``_phases``: (the whole output of this rank's branch batch, the
        next step's buffers)."""
        cfg = self.cfg
        if cfg.parallelism == "naive_patch" and cfg.is_sp:
            return self._naive_patch_unet(x_in, t, my_enc, my_added, text_kv, phase), state
        if not cfg.is_sp:
            out = unet_forward(self.params, self.ucfg, x_in, t, my_enc,
                               dispatch=self.dispatch(text_kv), added_cond=my_added)
            return out, state
        ctx = PatchContext(n=cfg.n_device_per_batch, mode=cfg.mode, phase=phase,
                           group=cfg.batch_group, split_idx=cfg.split_idx(),
                           state_in=state, text_kv=text_kv)
        out_local = unet_forward(self.params, self.ucfg, x_in, t, my_enc,
                                 dispatch=PatchDispatch(ctx), added_cond=my_added)
        state = ctx.finish()
        if phase == PHASE_SYNC:
            self._buffer_kinds = dict(ctx.kinds)
            self._buffer_numel = {k: v.numel() for k, v in state.items()}
        return gather_rows(out_local, cfg.batch_group), state

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
        PHASE_SYNC or PHASE_STALE, or ROW or COL under naive patch
        parallelism (``alternate`` by the absolute step's parity); one graph
        each.  Under displaced patch parallelism the synchronous steps are
        counted from ``start``: the first ``warmup_steps + 1`` steps that
        run (the reference counts ``counter <= warmup_steps`` as
        synchronous), so a run that starts mid-schedule (img2img, the
        second stage of a handoff) seeds its own stale buffers."""
        cfg = self.cfg
        if cfg.parallelism == "naive_patch" and cfg.is_sp:
            scheme = {"row": [ROW], "col": [COL], "alternate": [ROW, COL]}[cfg.split_scheme]
            return [scheme[i % len(scheme)] for i in range(start, end)]
        n_sync = end - start
        if cfg.parallelism == "patch" and cfg.is_sp and cfg.mode != "full_sync":
            n_sync = min(cfg.warmup_steps + 1, n_sync)
        return [PHASE_SYNC if i < start + n_sync else PHASE_STALE
                for i in range(start, end)]

    def _inputs(self, latents, prompt_embeds, added_cond, guidance_scale):
        """The generation's tensors on this rank's device: (latent float32,
        this rank's embeddings, added conditioning, text KV, guidance
        scale)."""
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
        my_enc, my_added, _ = branch_select(cfg, prompt_embeds, added)
        # tensor parallelism recomputes the text KV with its sharded kernels
        # at every step, as the reference's TP attention does (no cache)
        text_kv = ({} if cfg.parallelism == "tensor"
                   else precompute_text_kv(self.params, my_enc))
        gs = torch.tensor(guidance_scale, dtype=torch.float32, device=dev)
        x = torch.as_tensor(latents).to(dev, torch.float32)
        return x, my_enc, my_added, text_kv, gs

    def _model_input(self, x, i):
        x_in = self.scheduler.scale_model_input(x, i)
        if self.cfg.do_classifier_free_guidance and not self.cfg.cfg_split:
            x_in = torch.cat([x_in, x_in], dim=0)
        return x_in

    def _begin_graphs(self, x, my_enc, my_added, text_kv, phases, start=0) -> None:
        """Capture (on a card) the graphs of ``phases`` for this
        generation's shape, if not yet captured, and load its
        conditioning into their static inputs; ``start`` is the first
        step that runs."""
        check_graph_transport(self.cfg)
        t0 = self.scheduler.timesteps()[start].to(x.device)
        stateful = [PHASE_STALE] if PHASE_STALE in phases else []
        self.graphs.begin(
            tuple(x.shape), self._model_input(x, start), t0, my_enc, my_added, text_kv,
            list(dict.fromkeys(phases)), stateful, self._evaluate)

    def _evaluate(self, phase, inputs, state):
        """``_unet_local`` on a graph's static inputs."""
        return self._unet_local(inputs.x_in, inputs.t, inputs.enc, inputs.added,
                                inputs.text_kv, phase, state)

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
        timesteps = sched.timesteps().to(x.device)
        batch = x.shape[0]
        sstate = sched.init_state(x.shape)
        self.phase_counts = {PHASE_SYNC: 0, PHASE_STALE: 0}
        state = None
        for i, phase in enumerate(phases, start=start_step):
            x_in = self._model_input(x, i)
            if graphed:
                graph = self.graphs[phase]
                graph.inputs.set_step(x_in, timesteps[i])
                if graph.stateful:
                    graph.load_state(state)
                out, state = graph.replay(self._evaluate)
            else:
                out, state = self._unet_local(x_in, timesteps[i], my_enc, my_added,
                                              text_kv, phase, state)
            guided = combine_guidance(cfg, out, gs, batch)
            x, sstate = sched.step(x, guided.float(), i, sstate)
            self.phase_counts[PHASE_STALE if phase == PHASE_STALE else PHASE_SYNC] += 1
            if callback is not None:
                callback(i, sched.timesteps()[i], x)
        if cfg.verbose and not self._buffers_reported:
            self._buffers_reported = True
            self.comm_volume_report()
        return x

    def comm_volume_report(self) -> Dict[str, int]:
        """Elements of this rank's per-layer stale buffers by layer kind
        ("conv2d" halos, "attn" gathered KV, "gn" gathered moments), as the
        JAX package's ``comm_volume_report`` counts them; read from the
        buffers the last ``generate`` seeded.  Empty when the image is not
        in displaced patches.  Under ``verbose`` it also prints them, as
        the JAX package does."""
        if not self.cfg.is_sp or self.cfg.parallelism != "patch":
            return {}
        if not self._buffer_numel:
            raise RuntimeError("comm_volume_report reads the buffers of the last "
                               "generate(); call generate() first")
        report: Dict[str, int] = {}
        for name, numel in self._buffer_numel.items():
            kind = self._buffer_kinds[name]
            report[kind] = report.get(kind, 0) + numel
        if self.cfg.verbose:
            total = sum(report.values())
            print(f"Stale-state buffers: {total / 1e6:.3f}M elements over "
                  f"{len(self._buffer_numel)} tensors per device.")
            for kind, numel in sorted(report.items()):
                print(f"  {kind}: {numel / 1e6:.3f}M elements")
        return report


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
