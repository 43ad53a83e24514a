"""Displaced patch parallelism for the MMDiT (SD3's joint transformer), one
rank of it (or one device).

Counterpart of distrifuser_tpu/parallel/mmdit_sp.py (``MMDiTDenoiseRunner``
with ``attn_impl`` "gather" and "ring", its ``comm_report`` and
``generate``).  The image tokens shard over the patch group, each rank a
contiguous range of N/n tokens (a horizontal band), and the joint attention
is the only op that crosses patches.  Its keys are ``concat(context,
image)``, which splits the exchange in two:

* the context stream is short (154 tokens for SD3 at 1024x1024) and feeds
  every later block's image stream, so every rank computes it whole,
  replicated: its KV needs no exchange and is never stale;
* the image stream's KV is the only exchange.  Synchronous steps (the first
  ``warmup_steps + 1``, or every step under ``full_sync`` or without
  patches): "gather" all-gathers every block's fresh image KV over the
  patch group; "ring" streams the peers' fresh chunks through
  ops/ring_attention.py with the context KV merged as a non-rotating static
  block.  Stale steps: "gather" attends over the previous step's gathered
  image KV with this rank's slot fresh and issues the refresh for the next
  step (ops/attention.py ``displaced_kv``); "ring" rotates each peer's
  previous-step chunk, and the next buffer is the own fresh chunk.
  ``no_sync`` keeps the warmup's buffers for good.

SD3.5-medium's dual blocks exchange their image-only attention's KV the
same way, in buffers of their own (``blocks_dual.<i>`` beside
``blocks.<i>``).  The final layer's rows all-gather over the patch group
into the whole velocity; the CFG branches fold into the batch or split over
ranks (parallel/guidance.py); under ``dp_degree`` each image group
evaluates its share of the batch and the guided outputs gather before the
replicated float32 scheduler step, as the DiT runner does: both runners'
loop, graphs and ``comm_report`` are parallel/dit_sp.py's
``TransformerRunner``.

Under ``use_cuda_graph`` each phase's evaluation is captured once and
replayed (parallel/graphs.py): the token input, timestep and step are
copied into the graph's static inputs before each replay, the projected
context and the pooled text once per generation, and the stale graph's
buffers are copied back after each replay.  The conditioning vector is
computed inside the evaluation from the timestep and the pooled text.

The comm knobs are the DiT runner's: the gather layout's stale refresh
compressed (one float32 scale per row of k and one per row of v) and
partial, for the joint blocks' image KV and the dual blocks' second KV
alike; the step cache cuts past the dual-attention prefix
(``step_cache_depth`` in [1, depth - max(dual_attention_blocks, 1)]), so
a shallow step runs the whole dual prefix and the joint blocks up to the
cut, and the dual blocks' second KV refreshes on every step.

Refusals, with the JAX runner's exception types (``ValueError``): ulysses
and usp are undefined for joint attention's two-origin queries,
``comm_batch`` has nothing to batch, and the gather refresh's knobs apply
to "gather" only.
"""

from __future__ import annotations

import torch

from ..models import mmdit as mm
from ..models.dit import patchify
from ..models.mmdit import MMDiTConfig
from ..ops.attention import displaced_kv
from ..ops.ring_attention import ring_attend
from ..schedulers import BaseScheduler
from ..utils.config import DistriConfig
from .context import PatchContext
from .dit_sp import TransformerRunner, check_refresh_knobs
from .guidance import branch_select


def check_mmdit_config(cfg: DistriConfig, mcfg: MMDiTConfig) -> None:
    """The JAX runner's refusals (ValueError)."""
    if cfg.attn_impl not in ("gather", "ring"):
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r}: the MMDiT runner implements 'gather' "
            "(the whole stale image KV) and 'ring' (the own chunk; the replicated "
            "context KV rides the ring as a non-rotating static block); the "
            "head-sharding ulysses/usp layouts are not defined for joint "
            "attention's two-origin queries")
    check_refresh_knobs(cfg, mcfg.num_tokens, "MMDiT")
    if cfg.step_cache_enabled:
        max_k = mcfg.depth - max(mcfg.dual_attention_blocks, 1)
        if not 1 <= cfg.step_cache_depth <= max_k:
            raise ValueError(
                f"step_cache_depth={cfg.step_cache_depth} must be in [1, {max_k}] for "
                f"this {mcfg.depth}-block MMDiT: the cut must stay below the "
                f"dual-attention prefix ({mcfg.dual_attention_blocks} blocks) and leave "
                "at least one shallow block")
    if cfg.height // 8 != mcfg.sample_size or cfg.width // 8 != mcfg.sample_size:
        raise ValueError(
            f"DistriConfig {cfg.height}x{cfg.width} implies latent {cfg.latent_height}, "
            f"but MMDiTConfig.sample_size is {mcfg.sample_size}")
    if cfg.parallelism != "patch":
        raise ValueError(f"the MMDiT runs displaced patch parallelism (parallelism="
                         f"'patch'), not {cfg.parallelism!r}")


class MMDiTDenoiseRunner(TransformerRunner):
    """The denoising loop of one (config, MMDiT, scheduler) on this rank."""

    def __init__(self, distri_config: DistriConfig, mmdit_config: MMDiTConfig, params,
                 scheduler: BaseScheduler):
        check_mmdit_config(distri_config, mmdit_config)
        super().__init__(distri_config, mmdit_config, params, scheduler)

    @property
    def n_attn(self) -> int:
        return self.mcfg.depth + self.mcfg.dual_attention_blocks

    @property
    def n_attn_shallow(self) -> int:
        return self.d_keep + self.mcfg.dual_attention_blocks

    def _local(self, x_in, t, cond, phase, state, step=None):
        """One MMDiT evaluation on this rank's token rows of ``x_in`` [Bl, N,
        D] (scaled, the CFG branches folded) from ``cond`` = (the projected
        context [Bl, Lc, hidden], the pooled text [Bl, P], None) at the
        absolute step ``step`` (which a partial refresh rotates by): (the
        whole velocity [Bl, N, D_out], the next step's buffers)."""
        mcfg, params = self.mcfg, self.params
        ctx0, pooled, _ = cond
        dtype = params["proj_in"]["kernel"].dtype
        ctx = self._context(phase, state, step)
        chunk = mcfg.num_tokens // ctx.n
        offset = ctx.split_idx * chunk
        rows = x_in[:, offset:offset + chunk].to(dtype)
        pos = mm.pos_embed_cropped(mcfg, dtype, x_in.device)[offset:offset + chunk]
        vec = mm.cond_vec(params, mcfg, t, pooled)
        duals = params.get("blocks_dual", [])
        context = [ctx0]  # the context stream, which the blocks carry on

        def block(i, h):
            dual = duals[i] if i < len(duals) else None
            hooks = self._hooks(ctx, i, dual is not None) if ctx.n > 1 else {}
            h, context[0] = mm.mmdit_block(params["blocks"][i], mcfg, h, context[0], vec,
                                           dual_p=dual, **hooks)[:2]
            return h

        h = self._run_blocks(ctx, phase, mm.embed_tokens(params, rows, pos), block)
        return self._finish(ctx, phase, mm.final_layer(params, mcfg, h, vec))

    def _hooks(self, ctx: PatchContext, i: int, dual: bool):
        """The displaced-patch hooks of block ``i`` (and its dual attention):
        the gathered or stale image KV ("gather"), or the ring with the
        context KV as its static block ("ring")."""
        heads = self.mcfg.num_heads
        name, name2 = f"blocks.{i}", f"blocks_dual.{i}"
        if self.cfg.attn_impl == "ring":
            def joint(cq, xq, ckv, xkv):
                return ring_attend(torch.cat([cq, xq], dim=1), xkv, ctx, name,
                                   heads=heads, kv_static=ckv)

            hooks = {"attn_core": joint}
            if dual:
                hooks["attn2_core"] = lambda q2, kv2: ring_attend(q2, kv2, ctx, name2,
                                                                  heads=heads)
            return hooks
        hooks = {"kv_assemble": lambda kv: displaced_kv(kv, ctx, name, halves=2)}
        if dual:
            hooks["kv2_assemble"] = lambda kv2: displaced_kv(kv2, ctx, name2, halves=2)
        return hooks

    _family = "mmdit"

    def _inputs(self, latents, enc, pooled):
        """(the latent's tokens float32 [B, N, D], ``_cond_of``) from the
        latents, branch-major ``enc`` and ``pooled``."""
        dev = self.cfg.device
        x = patchify(self.mcfg, torch.as_tensor(latents).to(dev, torch.float32))
        return x, self._cond_of(enc, pooled)

    def _cond_of(self, enc, pooled):
        """(this rank's projected context [Bl, Lc, hidden], its pooled
        text [Bl, P], None) from branch-major ``enc`` [n_br, B, Lc,
        joint_dim] and ``pooled`` [n_br, B, P]."""
        cfg = self.cfg
        dev = cfg.device
        enc, pooled = (torch.as_tensor(t).to(dev) for t in (enc, pooled))
        my_enc, _, _ = branch_select(cfg, self._my_images(enc, dim=1))
        my_pooled, _, _ = branch_select(cfg, self._my_images(pooled, dim=1))
        return mm.context_in(self.params, my_enc), my_pooled, None

    @torch.inference_mode()
    def prepare(self, latents, enc, pooled, *, num_inference_steps: int = 20) -> None:
        """Capture, ahead of the first call, the graphs a generation of these
        shapes and ``num_inference_steps`` steps replays; the input values do
        not matter.  Nothing to do without ``use_cuda_graph``."""
        self._prepare(num_inference_steps, latents, enc, pooled)

    @torch.inference_mode()
    def generate(self, latents, enc, pooled, guidance_scale: float = 5.0,
                 num_inference_steps: int = 20, start_step: int = 0, end_step=None,
                 callback=None):
        """Run the loop: ``latents`` [B, H/8, W/8, C] (noise, or with
        ``start_step`` > 0 a clean latent noised to that schedule point by
        the scheduler's ``add_noise``: img2img), ``enc`` [n_branches, B, Lc,
        joint_dim] and ``pooled`` [n_branches, B, P], branch 0
        unconditional; every rank passes the same.  Steps ``start_step ..
        end_step - 1`` run; ``callback(i, t, latents)`` after each.  Returns
        the latent float32 [B, H/8, W/8, C], the same on every rank."""
        return self._generate((latents, enc, pooled), guidance_scale, num_inference_steps,
                              start_step, end_step, callback)
