"""PipeFusion: the DiT's blocks split into pipeline stages over the patch
group, the image's token chunks streaming through them.

Counterpart of distrifuser_tpu/parallel/pipefusion.py (``PipeFusionRunner``:
its refusals, ``comm_report`` and ``generate``; PipeFusion, arXiv
2405.14430).  The displaced patch runner (parallel/dit_sp.py) shards the
sequence and keeps every block on every rank; this one shards the depth:
rank p of the patch group (``split_idx``) holds blocks ``p*L/P ..
(p+1)*L/P - 1`` of the DiT's L, P = ``n_device_per_batch`` stages, and the
image's N tokens stream through the stages as M = ``pipe_patches`` (default
P) chunks of N/M rows.  Each block keeps a KV cache of the whole sequence:
a chunk's own rows are fresh, the others the newest the stage has seen.

Schedule.  The first ``warmup_steps + 1`` steps (every step under
``full_sync``) run the whole sequence as one mega-patch through the stages,
exactly; each stage's pass leaves fresh KV in its caches.  Then item q =
(step - n_sync) * M + chunk enters stage 0 at tick q and stage p works on
it at tick q + p; stage P - 1's output is the epsilon chunk, which the
ring carries back to stage 0 at tick q + P, where it is CFG-combined and
that chunk's latent rows are scheduler-stepped, each chunk with its own
scheduler state (DPM-Solver's previous x0 and lambda per chunk), before
the chunk is embedded again for its next step (M >= P makes it ready in
time).  Every (rank, tick) index is a host integer known before the run:
the item, its chunk and step, and whether it is valid.  The JAX runner
computes every stage at every tick inside one scan and discards the
invalid results; an invalid output only ever reaches consumers whose
item is invalid too, so this port runs only the valid (rank, tick) pairs
and sends or receives only where the peer's item is valid, which is
exact: one mega-patch pass a rank and synchronous step, one chunk pass a
rank and item.

Hops.  After each tick every rank calls ``collectives.ring_hop`` with its
valid side: its output to stage p + 1 if it worked on an item, a receive
from stage p - 1 if that stage did; each pair of neighbours pairs one send
with one receive, and a tick's hops wait only on ticks before it, so the
ring cannot deadlock.  At P = 1 the hop is the stage's own output (the JAX
self-permute).  Warmup hops carry the full-precision mega-patch; under
``comm_compress`` a steady hop carries the chunk quantized by the codec
kernels (ops/quantize.py: int8 or fp8, one float32 scale per token row;
``int8_residual`` codes the float32 difference to a per-chunk predictor
that sender and receiver advance to the same reconstruction, seeded by the
exact warmup hops, in float32).  The hops run between graph replays: their
pattern changes over the pipeline's fill and drain, which no single
captured graph can hold, and each is one point-to-point launch a tick.

Graphs.  ``use_cuda_graph`` is required, as the JAX runner requires its
compiled scan.  Three tick bodies are captured once a generation shape and
replayed (parallel/graphs.py ``TickGraphs``): the warmup's mega-patch pass,
the steady full tick and, under the step cache, the deep stages'
pass-through tick.  A body reads its step and chunk from device scalars
copied from device tables before each replay; the timestep embeddings, the
adaLN rows, the caption KV and mask, the KV cache, the step cache's deltas
and the predictors are per-generation buffers at fixed addresses.  Rows
are read and committed with ``index_select`` / ``index_copy_`` on device
indices (models/dit.py ``dit_block`` commits a block's fresh rows into its
cache in place before attending).  The embedding of stage 0's input, the
decode of a received chunk, the CFG combine and the scheduler step run
eagerly between replays, as the other runners keep the scheduler out of
their graphs.  ``capture_ticks = False`` replays the same bodies eagerly
(a comparison run, not a configuration).

Knobs.  The step cache's ``step_cache_depth`` counts stages: on a shallow
item the deepest K stages emit ``h_in + delta[chunk]`` and leave their
caches untouched, the delta recorded at their last full pass (warmup
passes too).  Under ``weight_quant`` each rank's blocks are quantized
block by block, which is the JAX package's depth-leading per-tile
quantization sliced to the stage.  ``hybrid_loop`` and ``comm_batch`` have
no effect here, as in the JAX runner.

Launches.  A rank's flash launches a generation are Lp = L/P for each
mega-patch pass (``n_sync`` of them) and for each full chunk pass (its
items, less the shallow items of a deep stage); ``tick_counts`` holds the
passes of each body after ``generate``.
"""

from __future__ import annotations

import types
from typing import Any, Dict, Optional

import torch

from ..models import dit as dit_mod
from ..models.dit import DiTConfig
from ..ops.quantize import (DecodeSeg, EncodeSeg, dequantize_rows_grouped,
                            quantize_rows_grouped)
from ..schedulers import BaseScheduler
from ..utils.config import DistriConfig
from .collectives import gather_batch, psum, ring_hop
from .compress import QuantizedTensor, payload_mode, wire_nbytes
from .graphs import TickGraphs
from .guidance import branch_select, combine_guidance
from .runner import StepLoop, check_graph_transport
from .stepcache import is_shallow_step

WARMUP, STEADY, PASS = "warmup", "steady", "pass"  # the tick bodies


def _numel(tree) -> int:
    """Elements of a parameter tree; a quantized kernel counts its payload
    and its scales, as the JAX tree's leaves do."""
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_numel(v) for v in tree)
    if isinstance(tree, QuantizedTensor):
        return tree.payload.numel() + tree.scale.numel()
    return tree.numel()


def stage_params(params, dit_config: DiTConfig, stages: int, stage: int):
    """``params`` with its blocks cut to stage ``stage``'s of ``stages``: a
    tree of the whole depth is sliced, one of depth / stages blocks is
    taken as the stage's already."""
    blocks = params["blocks"]
    per = dit_config.depth // stages
    if len(blocks) == per:
        return params
    if len(blocks) != dit_config.depth:
        raise ValueError(f"a tree of {len(blocks)} blocks is neither the DiT's "
                         f"{dit_config.depth} nor one stage's {per}")
    return {**params, "blocks": blocks[stage * per:(stage + 1) * per]}


def check_pipefusion_config(cfg: DistriConfig, dcfg: DiTConfig, stages: int,
                            patches: int) -> None:
    """The JAX runner's refusals (ValueError), in its order, then the
    port's own graph-transport refusal."""
    if cfg.attn_impl != "gather":
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r} applies to the displaced DiT runner "
            "(parallel/dit_sp.py); the pipeline's per-block KV cache is its own "
            "attention layout")
    if cfg.mode == "no_sync":
        raise ValueError(
            "mode='no_sync' does not apply to the patch pipeline: its KV caches "
            "refresh every tick by construction (freezing warmup KV is the "
            "displaced runners' knob); use the displaced DiT runner for no_sync")
    if not cfg.use_cuda_graph:
        raise ValueError(
            "use_cuda_graph=False (--no_cuda_graph) does not apply to the patch "
            "pipeline: its ticks run as the replays of their captured bodies, as "
            "the JAX runner runs them inside its compiled scan")
    if cfg.step_cache_enabled and cfg.step_cache_depth >= stages:
        raise ValueError(
            "under PipeFusion, step_cache_depth counts PIPELINE STAGES skipped on "
            f"shallow steps: depth {cfg.step_cache_depth} must be < the {stages} "
            "stages (stage 0 embeds and scheduler-steps, it can never be skipped)")
    if dcfg.depth % stages:
        raise ValueError(f"DiT depth {dcfg.depth} must divide evenly into {stages} "
                         "pipeline stages")
    if patches < stages:
        raise ValueError(
            f"pipe_patches ({patches}) must be >= pipeline stages ({stages}): the "
            "scheduler refresh of a patch returns to stage 0 exactly P ticks after "
            "it left, so fewer patches than stages would re-embed a latent that is "
            "not yet stepped")
    if dcfg.num_tokens % patches:
        raise ValueError(f"token count {dcfg.num_tokens} must be divisible by "
                         f"pipe_patches ({patches})")
    if dcfg.hidden_size < dcfg.token_out_dim:
        raise ValueError("hidden_size must be >= patch_size^2*out_channels so the "
                         "epsilon chunk rides the activation ring payload")
    if cfg.height // 8 != dcfg.sample_size or cfg.width // 8 != dcfg.sample_size:
        raise ValueError(
            f"DistriConfig {cfg.height}x{cfg.width} implies latent {cfg.latent_height}, "
            f"but DiTConfig.sample_size is {dcfg.sample_size} (square latents only "
            "for the DiT)")
    check_graph_transport(cfg)


class PipeFusionRunner(StepLoop):
    """The PipeFusion loop of one (config, DiT, scheduler) on this rank:
    ``generate`` takes what the displaced DiT runner's takes and returns the
    final latent on every rank.  ``params`` may hold the DiT's whole depth
    (it is cut to this rank's stage) or the stage's blocks only."""

    # False replays the tick bodies eagerly on the card (a comparison run)
    capture_ticks = True

    def __init__(self, distri_config: DistriConfig, dit_config: DiTConfig, params,
                 scheduler: BaseScheduler, pipe_patches: Optional[int] = None):
        cfg = distri_config
        self.cfg = cfg
        self.mcfg = dit_config
        self.scheduler = scheduler
        self.stages = cfg.n_device_per_batch
        if pipe_patches is None:
            pipe_patches = cfg.pipe_patches
        self.patches = self.stages if pipe_patches is None else pipe_patches
        check_pipefusion_config(cfg, dit_config, self.stages, self.patches)
        self.stage = cfg.split_idx() if self.stages > 1 else 0
        self.graphs = TickGraphs(cfg.device)
        self.params = stage_params(params, dit_config, self.stages, self.stage)
        if self.stages > 1:
            # the stage ring's communicator, made by all of its ranks at once:
            # a later hop pairs two of them only
            psum(torch.zeros(1, device=cfg.device), cfg.batch_group)
        self.tick_counts: Dict[str, int] = {}
        self._bufs = None

    # -- this rank's place in the pipeline ----------------------------------

    @property
    def is_first(self) -> bool:
        return self.stage == 0

    @property
    def is_last(self) -> bool:
        return self.stage == self.stages - 1

    @property
    def is_deep(self) -> bool:
        """Does this stage pass shallow items through (the step cache)?"""
        cfg = self.cfg
        return (cfg.step_cache_enabled
                and self.stage >= self.stages - cfg.step_cache_depth)

    @property
    def chunk(self) -> int:
        return self.mcfg.num_tokens // self.patches

    def _n_sync(self, num_steps: int) -> int:
        """Steps that run as the exact mega-patch."""
        if self.cfg.mode == "full_sync":
            return num_steps
        return min(self.cfg.warmup_steps + 1, num_steps)

    def _shallow(self, step: int, n_sync: int) -> bool:
        """Does a deep stage pass step ``step``'s items through?"""
        cfg = self.cfg
        return self.is_deep and is_shallow_step(step - n_sync, cfg.step_cache_interval)

    # -- the tick bodies ----------------------------------------------------

    def _split_patches(self, full):
        """[Bl, N, hid] -> [M, Bl, N/M, hid]."""
        b, _, hid = full.shape
        return full.reshape(b, self.patches, self.chunk, hid).transpose(0, 1)

    def _tail(self, h, step):
        """The stage's output: the epsilon rows padded to the hidden width
        on the last stage, else the activation."""
        if not self.is_last:
            return h
        temb = self._bufs.temb.index_select(0, step.view(1))[0]
        eps = dit_mod.final_layer(self.params, self.mcfg, h, temb)
        pad = h.shape[-1] - eps.shape[-1]
        return torch.cat([eps, eps.new_zeros(*eps.shape[:-1], pad)], dim=-1)

    def _tick(self, kind, inputs, state):
        """One tick body on ``inputs`` (``TickInputs``): the stage's blocks
        (or the pass-through), the step cache's delta, the tail and, on a
        steady tick, the hop's encode.  Returns ``(payload, None)``."""
        bufs, dcfg = self._bufs, self.mcfg
        h_in, step, m = inputs.h, inputs.step, inputs.chunk.view(1)
        if kind == PASS:
            h = h_in + bufs.delta.index_select(0, m)[0]
        else:
            c6 = bufs.c6.index_select(0, step.view(1))[0]
            start = 0 if kind == WARMUP else inputs.chunk * self.chunk
            h = h_in
            for j, bp in enumerate(self.params["blocks"]):
                h = dit_mod.dit_block(bp, dcfg, h, c6, bufs.cap_kv[j],
                                      self_kv=bufs.cache[j], patch_start=start,
                                      cap_bias=bufs.cap_bias)[0]
            if self.is_deep:
                if kind == WARMUP:
                    bufs.delta.copy_(self._split_patches(h - h_in))
                else:
                    bufs.delta.index_copy_(0, m, (h - h_in)[None])
        payload = self._tail(h, step)
        if kind == WARMUP:
            if self.cfg.comm_compress == "int8_residual":
                bufs.send_pred.copy_(self._split_patches(payload.float()))
            return payload, None
        return self._encode(payload, m), None

    def _encode(self, payload, m):
        """A steady hop's payload: raw, or (q, s) from the codec kernel,
        the residual coded against the chunk's sender predictor, which
        advances to the receiver's reconstruction."""
        mode = self.cfg.comm_compress
        if mode == "none":
            return payload
        if mode != "int8_residual":
            return tuple(quantize_rows_grouped([EncodeSeg(payload)], mode)[0])
        pred = self._bufs.send_pred.index_select(0, m)[0]
        q, s = quantize_rows_grouped([EncodeSeg(payload.float(), base=pred)], "int8")[0]
        recon = dequantize_rows_grouped([DecodeSeg(q, s, base=pred)], torch.float32)[0]
        self._bufs.send_pred.index_copy_(0, m, recon[None])
        return q, s

    def _decode(self, got, m: int):
        """The received chunk ``m`` in the compute dtype (eager): the
        dequantized payload, plus the receiver predictor under the residual
        code, which it becomes."""
        mode, dtype = self.cfg.comm_compress, self._bufs.dtype
        if mode == "none":
            return got
        q, s = got
        if mode != "int8_residual":
            return dequantize_rows_grouped([DecodeSeg(q, s)], dtype)[0]
        pred = self._bufs.recv_pred[m]
        dec = dequantize_rows_grouped([DecodeSeg(q, s, base=pred)], torch.float32)[0]
        pred.copy_(dec)
        return dec.to(dtype)

    # -- per-generation buffers and graphs ------------------------------------

    def _setup(self, cap_enc, cap_mask, num_steps: int):
        """The generation's buffers (kept while the shapes hold, so that
        captured graphs keep their addresses), its tables filled, the tick
        bodies it runs captured, the state buffers reset."""
        cfg, dcfg, params = self.cfg, self.mcfg, self.params
        dev = cfg.device
        dtype = params["proj_in"]["kernel"].dtype
        my_enc, _, _ = branch_select(cfg, self._my_images(cap_enc, dim=1))
        my_mask, _, _ = branch_select(cfg, self._my_images(cap_mask, dim=1))
        cap_kv = dit_mod.precompute_caption_kv(params, dcfg, my_enc)
        cap_bias = dit_mod.caption_mask_bias(my_mask)
        bloc = my_enc.shape[0]
        n_tok, hid, m = dcfg.num_tokens, dcfg.hidden_size, self.patches
        key = (bloc, tuple(cap_bias.shape), num_steps, dtype)
        if self._bufs is None or self._bufs.key != key:
            self.graphs.clear()
            self._bufs = None  # the old buffers go before the new ones come
            per = (m, bloc, self.chunk, hid)
            residual = cfg.comm_compress == "int8_residual"
            self._bufs = types.SimpleNamespace(
                key=key, dtype=dtype,
                cache=[torch.zeros(bloc, n_tok, 2 * hid, dtype=dtype, device=dev)
                       for _ in params["blocks"]],
                cap_kv=[torch.empty_like(kv) for kv in cap_kv],
                cap_bias=torch.empty_like(cap_bias),
                temb=torch.empty(num_steps, hid, dtype=dtype, device=dev),
                c6=torch.empty(num_steps, 6, hid, dtype=dtype, device=dev),
                pos=dit_mod.pos_embed_table(dcfg, dtype, dev),
                delta=torch.zeros(per, dtype=dtype, device=dev) if self.is_deep else None,
                send_pred=(torch.zeros(per, dtype=torch.float32, device=dev)
                           if residual else None),
                recv_pred=(torch.zeros(per, dtype=torch.float32, device=dev)
                           if residual else None),
                steps=torch.arange(num_steps, device=dev),
                chunks=torch.arange(m, device=dev))
        bufs = self._bufs
        for dst, src in zip(bufs.cap_kv, cap_kv):
            dst.copy_(src)
        bufs.cap_bias.copy_(cap_bias)
        temb = dit_mod.t_embed(params, dcfg, self.scheduler.timesteps().to(dev))
        bufs.temb.copy_(temb)
        bufs.c6.copy_(torch.stack([dit_mod.adaln_table(params, dcfg, e) for e in temb]))
        n_sync = self._n_sync(num_steps)
        rows = {WARMUP: torch.empty(bloc, n_tok, hid, dtype=dtype, device=dev)}
        if n_sync < num_steps:
            rows[STEADY] = torch.empty(bloc, self.chunk, hid, dtype=dtype, device=dev)
            if any(self._shallow(s, n_sync) for s in range(n_sync, num_steps)):
                rows[PASS] = rows[STEADY]
        if dev.type != "cuda" or self.capture_ticks:
            self.graphs.begin(key, rows, self._tick)
        for t in [*bufs.cache, bufs.delta, bufs.send_pred, bufs.recv_pred]:
            if t is not None:
                t.zero_()
        return bloc

    def _run_tick(self, kind, h, step: int, m: int):
        """Replay tick body ``kind`` on input rows ``h`` at step ``step``,
        chunk ``m``; returns its payload."""
        bufs = self._bufs
        self.tick_counts[kind] += 1
        if self.cfg.device.type == "cuda" and not self.capture_ticks:
            inputs = types.SimpleNamespace(h=h, step=bufs.steps[step], chunk=bufs.chunks[m])
            return self._tick(kind, inputs, None)[0]
        graph = self.graphs[kind]
        graph.inputs.set_tick(h, bufs.steps[step], bufs.chunks[m])
        return graph.replay(self._tick)[0]

    def _hop(self, out, recv_shapes):
        """The tick's hop: ``out`` (a tensor or a (q, s) pair; None: nothing
        to send) to the next stage, a payload of ``recv_shapes`` from the
        previous one if given; at one stage the output itself."""
        if self.stages == 1:
            return out
        parts = None if out is None else list(out) if isinstance(out, tuple) else [out]
        got = ring_hop(parts, recv_shapes, self.cfg.device, self.cfg.batch_group)
        if got is None:
            return None
        return tuple(got) if len(got) == 2 else got[0]

    def _steady_shapes(self, bloc):
        hid, dtype = self.mcfg.hidden_size, self._bufs.dtype
        shape = (bloc, self.chunk, hid)
        mode = self.cfg.comm_compress
        if mode == "none":
            return [(shape, dtype)]
        pdt = torch.float8_e4m3fn if payload_mode(mode) == "fp8" else torch.int8
        return [(shape, pdt), (shape[:2], torch.float32)]

    # -- the loop -----------------------------------------------------------

    def _embed(self, x, step: int, m: Optional[int]):
        """Stage 0's input: this image group's latent tokens (chunk ``m``,
        or all of them), scaled for ``step``, embedded at their positions,
        the CFG branches folded unless split."""
        bufs, cfg = self._bufs, self.cfg
        rows = x if m is None else x[:, m * self.chunk:(m + 1) * self.chunk]
        pos = bufs.pos if m is None else bufs.pos[m * self.chunk:(m + 1) * self.chunk]
        tok = self.scheduler.scale_model_input(rows, step).to(bufs.dtype)
        if cfg.do_classifier_free_guidance and not cfg.cfg_split:
            tok = torch.cat([tok, tok], dim=0)
        return dit_mod.embed_tokens(self.params, self.mcfg, tok, pos)

    def _sched_chunk(self, x, states, eps, m: int, step: int, gs):
        """CFG-combine chunk ``m``'s epsilon rows and scheduler-step its
        latent rows at ``step`` with its own state."""
        d_out = self.mcfg.token_out_dim
        lo, hi = m * self.chunk, (m + 1) * self.chunk
        guided = combine_guidance(self.cfg, eps[..., :d_out], gs, x.shape[0])
        x[:, lo:hi], states[m] = self.scheduler.step(x[:, lo:hi], guided.float(), step,
                                                     states[m])

    def _run(self, x, num_steps: int, gs, bloc: int):
        """Both phases of the schedule on this rank; ``x`` float32 [b, N,
        D] (this image group's tokens), stepped in place on stage 0."""
        P, M, p = self.stages, self.patches, self.stage
        sched, chunk = self.scheduler, self.chunk
        n_tok, hid, dtype = self.mcfg.num_tokens, self.mcfg.hidden_size, self._bufs.dtype
        states = [sched.init_state((x.shape[0], chunk, x.shape[2])) for _ in range(M)]
        residual = self.cfg.comm_compress == "int8_residual"
        n_sync = self._n_sync(num_steps)
        self.tick_counts = {WARMUP: 0, STEADY: 0, PASS: 0}

        # the mega-patch warmup: stage a works at tick s * P + a of step s
        def works(stage, tau):
            return tau % P == stage and tau // P < n_sync

        got = None
        for tau in range(n_sync * P + 1):
            s = tau // P
            if p == 0 and tau % P == 0 and s >= 1:  # step s - 1's epsilon is back
                for m in range(M):
                    lo = m * chunk
                    self._sched_chunk(x, states, got[:, lo:lo + chunk], m, s - 1, gs)
                if residual:
                    self._bufs.recv_pred.copy_(self._split_patches(got.float()))
            out = None
            if works(p, tau):
                if p == 0:
                    h = self._embed(x, s, None)
                else:
                    h = got
                    if residual:
                        self._bufs.recv_pred.copy_(self._split_patches(got.float()))
                out = self._run_tick(WARMUP, h, s, 0)
            recv = [((bloc, n_tok, hid), dtype)] if works((p - 1) % P, tau) else None
            got = self._hop(out, recv)
        if n_sync >= num_steps:
            return

        # the steady stream: stage p works on item tau - p at tick tau
        n_items = (num_steps - n_sync) * M
        shapes = self._steady_shapes(bloc)

        def valid(q):
            return 0 <= q < n_items

        got = None
        for tau in range(n_items + P):
            q_my = tau - p
            h = None
            if p == 0:
                q_back = tau - P
                if valid(q_back):
                    m = q_back % M
                    eps = self._decode(got, m)
                    self._sched_chunk(x, states, eps, m, n_sync + q_back // M, gs)
                if valid(tau):
                    h = self._embed(x, n_sync + tau // M, tau % M)
            elif valid(q_my):
                h = self._decode(got, q_my % M)
            out = None
            if valid(q_my):
                s, m = n_sync + q_my // M, q_my % M
                kind = PASS if self._shallow(s, n_sync) else STEADY
                out = self._run_tick(kind, h, s, m)
            q_next = tau + 1 - (P if p == 0 else p)  # what arrives for the next tick
            got = self._hop(out, shapes if valid(q_next) else None)

    def _inputs(self, latents, enc, cap_mask):
        dev = self.cfg.device
        x = dit_mod.patchify(self.mcfg, torch.as_tensor(latents).to(dev, torch.float32))
        enc = torch.as_tensor(enc).to(dev)
        mask = (torch.ones(enc.shape[:3], device=dev) if cap_mask is None
                else torch.as_tensor(cap_mask).to(dev).float())
        return x, enc, mask

    @torch.inference_mode()
    def prepare(self, latents, enc, *, num_inference_steps: int = 20,
                cap_mask=None) -> None:
        """Capture, ahead of the first call, the tick bodies a generation of
        these shapes and ``num_inference_steps`` steps replays; the input
        values do not matter."""
        self.scheduler.set_timesteps(num_inference_steps)
        _, enc, mask = self._inputs(latents, enc, cap_mask)
        self._setup(enc, mask, num_inference_steps)

    @torch.inference_mode()
    def generate(self, latents, enc, guidance_scale: float = 5.0,
                 num_inference_steps: int = 20, cap_mask=None, callback=None):
        """``latents`` [B, H/8, W/8, C] float32 initial noise, ``enc``
        [n_branches, B, Lt, caption_dim] (branch 0 unconditional),
        ``cap_mask`` [n_branches, B, Lt] (None: every token real), the same
        on every rank.  Returns the final latent float32 [B, H/8, W/8, C]
        on every rank.  Per-step callbacks are refused, as by the JAX
        runner: a step is smeared over the pipeline's ticks."""
        if callback is not None:
            raise ValueError(
                "per-step callbacks are not available under PipeFusion: a denoising "
                "step is smeared across the pipeline's token ticks, so there is no "
                "per-step boundary to fire from — use parallelism='patch' "
                "(DiTDenoiseRunner fires callbacks in every mode)")
        cfg, dcfg = self.cfg, self.mcfg
        self.scheduler.set_timesteps(num_inference_steps)
        x, enc, mask = self._inputs(latents, enc, cap_mask)
        bloc = self._setup(enc, mask, num_inference_steps)
        gs = torch.tensor(guidance_scale, dtype=torch.float32, device=cfg.device)
        mine = self._my_images(x).clone()  # may view the caller's latents
        self._run(mine, num_inference_steps, gs, bloc)
        if self.stages > 1:  # stage 0 holds the result
            mine = psum(mine if self.is_first else torch.zeros_like(mine), cfg.batch_group)
        if cfg.dp_degree > 1:
            mine = gather_batch(mine, cfg.dp_group)
        return dit_mod.unpatchify(dcfg, mine, dcfg.in_channels)

    # -- observability ------------------------------------------------------

    def comm_report(self, batch_size: int = 1) -> Dict[str, Any]:
        """This rank's memory and traffic, closed-form, as the JAX runner's
        ``comm_report`` gives them (the same keys and numbers):
        ``params_per_device`` counts the shared parameters and this
        stage's blocks, which is what the rank holds; a steady step is
        ``patches`` hops of one (compressed or raw) chunk, a warmup step
        ``stages`` hops of the full-precision mega-patch; shallow steps
        hop as many bytes (the chunk still travels to stage 0)."""
        cfg, dcfg = self.cfg, self.mcfg
        n_tok, hid = dcfg.num_tokens, dcfg.hidden_size
        l_per = dcfg.depth // self.stages
        chunk = self.chunk
        bloc = batch_size * (2 if cfg.do_classifier_free_guidance and not cfg.cfg_split
                             else 1)
        one_block = _numel(self.params["blocks"][0])
        shared = _numel({k: v for k, v in self.params.items() if k != "blocks"})
        itemsize = cfg.dtype.itemsize
        ring = self.stages > 1  # a one-stage "ring" is a self-permute
        hop = wire_nbytes((bloc, chunk, hid), itemsize, cfg.comm_compress) if ring else 0
        warm_hop = bloc * n_tok * hid * itemsize if ring else 0
        per_step_elems = self.patches * bloc * chunk * hid if ring else 0
        report = {
            "stages": self.stages,
            "patches": self.patches,
            "params_per_device": shared + one_block * l_per,
            "params_replicated_equiv": shared + one_block * dcfg.depth,
            "kv_cache_elems_per_device": l_per * 2 * bloc * n_tok * hid,
            "ring_payload_elems_per_tick": bloc * chunk * hid,
            "ticks_per_step_steady": self.patches,
            "bubble_ticks": self.stages,
            "comm_compress": cfg.comm_compress,
            "per_hop_bytes": int(hop),
            "warmup_hop_bytes": int(warm_hop),
            "per_step_collective_elems": int(per_step_elems),
            "per_step_collective_bytes": int(self.patches * hop),
            "sync_step_collective_bytes": int(self.stages * warm_hop),
            "per_step_cfg_gather_bytes": int(
                self.patches * batch_size * chunk * dcfg.token_out_dim * itemsize
                if cfg.cfg_split else 0),
        }
        if cfg.step_cache_enabled:
            report["step_cache"] = {
                "interval": cfg.step_cache_interval,
                "depth": cfg.step_cache_depth,
                "shallow_per_step_collective_elems": int(per_step_elems),
            }
        return report
