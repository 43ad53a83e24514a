"""Rank workers of the multi-rank tests of the PyTorch port (no tests here).

``run_ranks`` spawns ``world`` processes that join one gloo process group
through a file under the test's temporary directory (so that concurrent
test workers never compete for a TCP port), run one of the workers below
and leave their results in files.  A spawned process imports this module
to find its worker, so the module imports neither jax nor the JAX package
(tests/test_torch_port_static.py walks it): inputs arrive as files that
the test wrote, parameter trees already in the port's layout.  Each worker
runs many cases in one spawn, because a spawn of four ranks costs seconds.
"""

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_ranks(world, worker, tmp_path, *args, join=True):
    """Run ``worker(rank, world, *args)`` on ``world`` gloo ranks; raises if
    any rank raises.  With ``join=False`` returns at once a function that
    waits for the ranks (and raises as above), so the caller can work
    meanwhile."""
    init = os.path.join(str(tmp_path), f"pg_init_{worker.__name__}_{world}")
    ctx = mp.spawn(_entry, args=(world, init, worker, args), nprocs=world, join=join)

    def wait():
        while not ctx.join():
            pass

    return None if join else wait


def _entry(rank, world, init, worker, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        worker(rank, world, *args)
        # no rank tears its connections down while a peer still uses them
        dist.barrier()
    finally:
        dist.destroy_process_group()


def jax_layout(tree):
    """A float32 parameter tree of the port as the JAX package holds it:
    numpy leaves, 4-D kernels HWIO (the inverse of ``params_from_jax``).
    Seeding a tree with the port's init and carrying it across this way is
    much cheaper than the JAX package's op-by-op init on the CPU."""
    if isinstance(tree, dict):
        return {k: jax_layout(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_layout(v) for v in tree]
    t = tree.detach()
    return (t.permute(2, 3, 1, 0) if t.dim() == 4 else t).contiguous().numpy()


def _rows(x, rank, world, dim=1):
    """This rank's contiguous block of ``x`` along ``dim``."""
    return x.chunk(world, dim=dim)[rank].contiguous()


def ops_worker(rank, world, in_path, out_path):
    """Each patch op on this rank's rows, at n = world (one patch group):
    a synchronous call on the first input, then a stale call on the second
    with the buffers of the first.  Saves {case: outputs}."""
    from distrifuser_tpu_torch.ops.attention import patch_self_attention
    from distrifuser_tpu_torch.ops.conv import patch_conv2d, sliced_conv2d
    from distrifuser_tpu_torch.ops.normalization import patch_group_norm
    from distrifuser_tpu_torch.parallel import collectives
    from distrifuser_tpu_torch.parallel.context import (PHASE_STALE, PHASE_SYNC,
                                                        PatchContext)
    from distrifuser_tpu_torch.parallel.guidance import combine_guidance
    from distrifuser_tpu_torch.utils.config import SYNC_MODES, DistriConfig

    inp = torch.load(in_path)
    group = dist.group.WORLD
    out = {}

    def two_steps(op, x1, x2, mode="corrected_async_gn"):
        ctx = PatchContext(n=world, mode=mode, phase=PHASE_SYNC, group=group,
                           split_idx=rank)
        y1 = op(_rows(x1, rank, world), ctx)
        s1 = ctx.finish()
        ctx = PatchContext(n=world, mode=mode, phase=PHASE_STALE, group=group,
                           split_idx=rank, state_in={k: v.clone() for k, v in s1.items()})
        y2 = op(_rows(x2, rank, world), ctx)
        return {"y_sync": y1, "state_sync": s1, "y_stale": y2, "state_stale": ctx.finish()}

    x1, x2 = inp["x1"], inp["x2"]
    for halo in (1, 2):
        out[f"halo_exchange_h{halo}"] = collectives.halo_exchange(
            _rows(x1, rank, world), halo, group)
    out["gather_rows"] = collectives.gather_rows(_rows(x1, rank, world), group)
    for stride in (1, 2):
        ctx = PatchContext(n=world, mode="full_sync", phase=PHASE_SYNC, group=group,
                           split_idx=rank)
        out[f"sliced_conv2d_s{stride}"] = sliced_conv2d(inp["conv"], x1, ctx,
                                                        stride=stride)
        out[f"patch_conv2d_s{stride}"] = two_steps(
            lambda x, c, s=stride: patch_conv2d(inp["conv"], x, c, "conv", stride=s),
            x1, x2)
    for mode in SYNC_MODES:
        out[f"patch_group_norm_{mode}"] = two_steps(
            lambda x, c: patch_group_norm(inp["gn"], x, c, "gn", groups=4),
            x1, x2, mode)
    out["patch_self_attention"] = two_steps(
        lambda x, c: patch_self_attention(inp["attn"], x, c, "attn", heads=2),
        inp["tokens1"], inp["tokens2"])
    cfg = DistriConfig(device="cpu", height=8 * world, width=8)
    branch = inp["branches"][cfg.batch_idx()]
    out["cfg_combine"] = combine_guidance(cfg, branch, torch.tensor(5.0), branch.shape[0])
    torch.save(out, f"{out_path}.rank{rank}")


def runner_worker(rank, world, in_path, out_path):
    """The tiny SDXL runner (``make_runner``: patch, naive patch or tensor
    parallelism) in each case of ``cases`` (config fields): 4 DDIM steps
    from the same inputs.  Saves {case: (latent, comm volume, phase
    counts)}."""
    from distrifuser_tpu_torch.models import unet
    from distrifuser_tpu_torch.parallel.runner import make_runner
    from distrifuser_tpu_torch.schedulers import get_scheduler
    from distrifuser_tpu_torch.utils.config import DistriConfig

    inp = torch.load(in_path)
    ucfg = unet.tiny_config(cross_attention_dim=32, sdxl=True)
    out = {}
    for case in inp["cases"]:
        cfg = DistriConfig(device="cpu", height=128, width=128, warmup_steps=1,
                           **case)
        runner = make_runner(cfg, ucfg, inp["params"], get_scheduler("ddim"))
        x = runner.generate(inp["latents"], inp["enc"], added_cond=inp["added"],
                            num_inference_steps=4, guidance_scale=5.0)
        out[tuple(sorted(case.items()))] = (x, runner.comm_volume_report(),
                                            dict(runner.phase_counts))
    torch.save(out, f"{out_path}.rank{rank}")


def pipeline_worker(rank, world, in_path, out_path):
    """The tiny SDXL pipeline at this world (CFG split, warmup 1): latents
    after 3 steps with the steps the callback saw and the phase counts, and
    the image after 2 steps.  Saves them."""
    from distrifuser_tpu_torch import DistriConfig, DistriSDXLPipeline
    from distrifuser_tpu_torch.models import clip, unet, vae

    inp = torch.load(in_path)
    tcfgs = [clip.tiny_clip_config(hidden=16),
             clip.CLIPTextConfig(vocab_size=1000, hidden_size=16, num_hidden_layers=2,
                                 num_attention_heads=4, intermediate_size=32,
                                 projection_dim=32)]
    cfg = DistriConfig(device="cpu", height=128, width=128, warmup_steps=1)
    pipe = DistriSDXLPipeline.from_params(
        cfg, unet.tiny_config(cross_attention_dim=32, sdxl=True), inp["unet"],
        vae.tiny_vae_config(), inp["vae"], tcfgs, inp["text"])
    steps = []
    latent = pipe(inp["prompt"], latents=inp["latents"], num_inference_steps=3,
                  output_type="latent",
                  callback=lambda i, t, x: steps.append(i)).images[0]
    phases = dict(pipe.runner.phase_counts)
    image = pipe(inp["prompt"], latents=inp["latents"], num_inference_steps=2,
                 output_type="np").images[0]
    torch.save({"latent": latent, "image": image, "steps": steps,
                "phase_counts": phases},
               f"{out_path}.rank{rank}")


def sd_pipeline_worker(rank, world, in_path, out_path):
    """The tiny SD pipeline at this world in each case of ``cases`` (config
    fields), from the UNet, VAE and text configs' fields and trees in the
    input: latents after 3 steps from the input latents, or after the
    input's ``call`` keywords (img2img) where it has them, with the phase
    counts.  Saves {case: (latent, phase counts)}."""
    from distrifuser_tpu_torch import DistriConfig, DistriSDPipeline
    from distrifuser_tpu_torch.models import clip, unet, vae

    inp = torch.load(in_path)
    out = {}
    for case in inp["cases"]:
        cfg = DistriConfig(device="cpu", height=128, width=128, **case)
        pipe = DistriSDPipeline.from_params(
            cfg, unet.UNetConfig(**inp["unet_config"]), inp["unet"],
            vae.VAEConfig(**inp["vae_config"]), inp["vae"],
            [clip.CLIPTextConfig(**inp["text_config"])], [inp["text"]],
            scheduler=inp["scheduler"])
        call = inp.get("call") or {"latents": inp["latents"], "num_inference_steps": 3}
        latent = pipe(inp["prompt"], output_type="latent", **call).images[0]
        out[tuple(sorted(case.items()))] = (latent, dict(pipe.runner.phase_counts))
    torch.save(out, f"{out_path}.rank{rank}")


def _tiny_runner_inputs(inp):
    return inp["latents"], inp["enc"], inp["added"]


def knobs_worker(rank, world, in_path, out_path):
    """The tiny SDXL runner in each case of ``cases`` (config fields over
    ``base``) for ``steps`` DDIM steps: saves {case: (latent, per-phase comm
    report, phase counts, comm plan)}."""
    torch.save(_knob_runs(torch.load(in_path)), f"{out_path}.rank{rank}")


def _knob_runs(inp):
    from types import SimpleNamespace

    from distrifuser_tpu_torch.models import unet
    from distrifuser_tpu_torch.parallel.runner import make_runner
    from distrifuser_tpu_torch.pipelines import DistriSDXLPipeline
    from distrifuser_tpu_torch.schedulers import get_scheduler
    from distrifuser_tpu_torch.utils.config import DistriConfig

    ucfg = unet.tiny_config(cross_attention_dim=32, sdxl=inp.get("sdxl", True))
    latents, enc, added = _tiny_runner_inputs(inp)
    out = {}
    for case in inp["cases"]:
        cfg = DistriConfig(device="cpu", height=128, width=128,
                           **{**inp["base"], **case})
        runner = make_runner(cfg, ucfg, inp["params"], get_scheduler("ddim"))
        x = runner.generate(latents, enc, added_cond=added,
                            num_inference_steps=inp["steps"], guidance_scale=5.0)
        rep = runner.comm_volume_report(per_phase=True)
        plan = DistriSDXLPipeline.comm_plan(
            SimpleNamespace(distri_config=cfg, runner=runner), inp["steps"])
        out[tuple(sorted(case.items()))] = (x, rep, dict(runner.phase_counts), plan)
    return out


def refresh_worker(rank, world, in_path, out_path):
    """One stale step's refresh emissions, on identical inputs, in each
    case of ``cases`` (context fields): a KV gather ("attn"), a halo pair
    ("conv") and GroupNorm moments ("gn") from this rank's slice of the
    input and its buffers, then the context's ``finish``.  Saves {case:
    (buffers, wire bytes, kinds)}."""
    from distrifuser_tpu_torch.parallel.context import PHASE_STALE, PatchContext

    inp = torch.load(in_path)
    out = {}
    for case in inp["cases"]:
        state = {k: v[rank].clone() for k, v in inp["state"].items()}
        ctx = PatchContext(n=world, mode="corrected_async_gn", phase=PHASE_STALE,
                           group=dist.group.WORLD, split_idx=rank, state_in=state,
                           step=inp["step"], **dict(case))
        ctx.emit_refresh_gather("attn", inp["kv"][rank], "attn")
        ctx.emit_refresh_halos("conv", inp["x"][rank], 1)
        ctx.emit_refresh_gather("gn", inp["moments"][rank], "gn")
        got = ctx.finish()
        out[case] = ({k: v.clone() for k, v in got.items()}, dict(ctx.wire),
                     dict(ctx.kinds))
    torch.save(out, f"{out_path}.rank{rank}")


def ring_worker(rank, world, in_path, out_path):
    """Ring attention at n = world: ``ring_self_attention`` synchronous on
    the first tokens, stale on the second with the first step's buffer,
    beside ``patch_self_attention`` on the same inputs, and ``ring_pass`` on
    the given chunks; then the runs of ``knobs_worker`` in ``runner`` when
    the input has one.  Saves the outputs and buffers."""
    from distrifuser_tpu_torch.ops.attention import patch_self_attention
    from distrifuser_tpu_torch.ops.ring_attention import ring_pass, ring_self_attention
    from distrifuser_tpu_torch.parallel.context import (PHASE_STALE, PHASE_SYNC,
                                                        PatchContext)

    inp = torch.load(in_path)
    group = dist.group.WORLD
    out = {}
    for impl, fn in (("ring", ring_self_attention), ("gather", patch_self_attention)):
        for mode in ("full_sync", "corrected_async_gn"):
            ctx = PatchContext(n=world, mode=mode, phase=PHASE_SYNC, group=group,
                               split_idx=rank, attn_impl=impl)
            y1 = fn(inp["attn"], _rows(inp["tokens1"], rank, world), ctx, "attn",
                    heads=inp["heads"])
            s1 = ctx.finish()
            ctx = PatchContext(n=world, mode=mode, phase=PHASE_STALE, group=group,
                               split_idx=rank, attn_impl=impl,
                               state_in={k: v.clone() for k, v in s1.items()})
            y2 = fn(inp["attn"], _rows(inp["tokens2"], rank, world), ctx, "attn",
                    heads=inp["heads"])
            out[(impl, mode)] = {"y_sync": y1, "state_sync": s1, "y_stale": y2,
                                 "state_stale": ctx.finish()}
    out["ring_pass"] = ring_pass(inp["q"][rank], inp["kv"][rank], inp["kv"][rank],
                                 world, group, heads=inp["heads"])
    out["ring_pass_static"] = ring_pass(inp["q"][rank], inp["kv"][rank], inp["kv"][rank],
                                        world, group, heads=inp["heads"],
                                        kv_static=inp["kv_static"])
    if "runner" in inp:
        out["runner"] = _knob_runs(inp["runner"])
    torch.save(out, f"{out_path}.rank{rank}")


def stepwise_worker(rank, world, in_path, out_path):
    """The explicit-carry API on the tiny SDXL runner in each case of
    ``cases``: two carries (latents A and B) stepped interleaved, the same
    two stepped one after the other, and ``generate`` of each.  Saves {case:
    {"interleaved": (A, B), "contiguous": (A, B), "generate": (A, B),
    "signatures": [...]}}."""
    from distrifuser_tpu_torch.models import unet
    from distrifuser_tpu_torch.parallel.runner import make_runner
    from distrifuser_tpu_torch.schedulers import get_scheduler
    from distrifuser_tpu_torch.utils.config import DistriConfig

    inp = torch.load(in_path)
    ucfg = unet.tiny_config(cross_attention_dim=32, sdxl=True)
    steps, enc, added = inp["steps"], inp["enc"], inp["added"]
    out = {}
    for case in inp["cases"]:
        cfg = DistriConfig(device="cpu", height=128, width=128,
                           **{**inp["base"], **case})
        runner = make_runner(cfg, ucfg, inp["params"], get_scheduler("ddim"))

        def run(carry, i):
            return runner.stepwise_carry_step(carry, i, enc, added, 5.0, steps)

        carries = [runner.stepwise_carry_init(lat, steps) for lat in inp["latents"]]
        signatures = [runner.stepwise_carry_signature(carries[0], i, steps)
                      for i in range(steps)]
        for i in range(steps):
            carries = [run(c, i) for c in carries]
        interleaved = [runner.stepwise_carry_latent(c) for c in carries]
        contiguous = []
        for lat in inp["latents"]:
            carry = runner.stepwise_carry_init(lat, steps)
            for i in range(steps):
                carry = run(carry, i)
            contiguous.append(runner.stepwise_carry_latent(carry))
        generated = [runner.generate(lat, enc, added_cond=added, guidance_scale=5.0,
                                     num_inference_steps=steps)
                     for lat in inp["latents"]]
        out[tuple(sorted(case.items()))] = {
            "interleaved": interleaved, "contiguous": contiguous,
            "generate": generated, "signatures": signatures}
    torch.save(out, f"{out_path}.rank{rank}")


def transformer_stepwise_worker(rank, world, in_path, out_path):
    """The transformer runners' explicit-carry API (parallel/dit_sp.py) at
    sp ``world``, CFG folded, warmup 1: for the tiny DiT (DPM-solver) and
    the tiny MMDiT (flow-euler), two carries stepped interleaved, the same
    two stepped one after the other, and ``generate`` of each.  Saves
    {name: {"interleaved", "contiguous", "generate", "signatures"}}."""
    import dataclasses

    from distrifuser_tpu_torch.models import dit, mmdit
    from distrifuser_tpu_torch.parallel.dit_sp import DiTDenoiseRunner
    from distrifuser_tpu_torch.parallel.mmdit_sp import MMDiTDenoiseRunner
    from distrifuser_tpu_torch.schedulers import get_scheduler
    from distrifuser_tpu_torch.utils.config import DistriConfig

    inp = torch.load(in_path, weights_only=False)
    steps = inp["steps"]
    out = {}
    for name, cls, mcfg, sched, hw in (
            ("dit", DiTDenoiseRunner, dit.tiny_dit_config(depth=2), "dpm-solver", 128),
            ("mmdit", MMDiTDenoiseRunner,
             dataclasses.replace(mmdit.tiny_mmdit_config(), depth=2), "flow-euler", 256)):
        d = inp[name]
        cfg = DistriConfig(device="cpu", height=hw, width=hw, warmup_steps=1,
                           split_batch=False, use_cuda_graph=False)
        runner = cls(cfg, mcfg, d["params"], get_scheduler(sched))
        enc, extra = torch.from_numpy(d["enc"]), torch.from_numpy(d["extra"])
        lats = [torch.from_numpy(d["latents"][i:i + 1]) for i in range(2)]

        def run(carry, i):
            return runner.stepwise_carry_step(carry, i, enc, extra, 4.5, steps)

        carries = [runner.stepwise_carry_init(lat, steps) for lat in lats]
        signatures = [runner.stepwise_carry_signature(carries[0], i, steps)
                      for i in range(steps)]
        for i in range(steps):
            carries = [run(c, i) for c in carries]
        interleaved = [runner.stepwise_carry_latent(c) for c in carries]
        contiguous = []
        for lat in lats:
            carry = runner.stepwise_carry_init(lat, steps)
            for i in range(steps):
                carry = run(carry, i)
            contiguous.append(runner.stepwise_carry_latent(carry))
        second = {"cap_mask": extra} if name == "dit" else {"pooled": extra}
        generated = [runner.generate(lat, enc, guidance_scale=4.5, num_inference_steps=steps,
                                     **second) for lat in lats]
        out[name] = {"interleaved": interleaved, "contiguous": contiguous,
                     "generate": generated, "signatures": signatures}
    torch.save(out, f"{out_path}.rank{rank}")


def _tiny_sd_pipeline(cfg, vae_params):
    """The tiny SD pipeline (seeded port UNet and CLIP, the given tiny VAE)."""
    from distrifuser_tpu_torch import DistriSDPipeline
    from distrifuser_tpu_torch.models import clip, unet, vae

    ucfg, tcfg = unet.tiny_config(cross_attention_dim=32), clip.tiny_clip_config(hidden=32)
    return DistriSDPipeline.from_params(
        cfg, ucfg, unet.init_unet_params(torch.Generator().manual_seed(0), ucfg),
        vae.tiny_vae_config(), vae_params, [tcfg],
        [clip.init_clip_params(torch.Generator().manual_seed(1), tcfg)])


def vae_sp_worker(rank, world, in_path, out_path):
    """The sequence-parallel VAE at n = world over the default group:
    ``decode_sp`` of this rank's rows of the latents and ``encode_sp`` (the
    mean, and a sample from a seeded generator) of its rows of the images,
    each gathered in rank order; then the tiny SD pipeline's decode
    (``_decode_to_np``) of the latents in each case of ``cases`` (config
    fields) with its decoder choice.  Saves them."""
    from distrifuser_tpu_torch import DistriConfig
    from distrifuser_tpu_torch.models import vae
    from distrifuser_tpu_torch.parallel.collectives import gather_rows

    inp = torch.load(in_path)
    vcfg, params, group = vae.tiny_vae_config(), inp["vae"], dist.group.WORLD
    lat, img = inp["lat"], inp["img"]
    out = {
        "decode": gather_rows(vae.decode_sp(params, vcfg, _rows(lat, rank, world), world,
                                            group), group),
        "encode": gather_rows(vae.encode_sp(params, vcfg, _rows(img, rank, world), world,
                                            group), group),
        "sample": gather_rows(vae.encode_sp(params, vcfg, _rows(img, rank, world), world,
                                            group, generator=torch.Generator().manual_seed(7)),
                              group),
    }
    for case in inp["cases"]:
        cfg = DistriConfig(device="cpu", height=8 * lat.shape[1], width=8 * lat.shape[2],
                           use_cuda_graph=False, **case)
        pipe = _tiny_sd_pipeline(cfg, params)
        out[tuple(sorted(case.items()))] = (pipe.vae_decode_parallel, pipe.vae_decode_tile,
                                            torch.from_numpy(pipe._decode_to_np(lat)))
    torch.save(out, f"{out_path}.rank{rank}")


def dp_worker(rank, world, in_path, out_path):
    """The tiny SD runner (4 DDIM steps, warmup 1) in each case of ``runs``:
    (config fields, the images it takes: a list of indices into the input's
    latents and embeddings), with the latent shapes its callback saw; then
    the tiny SD pipeline in each case of ``pipelines``: (config fields,
    prompts, the images' indices), to latents and to images.  Saves {case
    index: results}."""
    from distrifuser_tpu_torch.models import unet
    from distrifuser_tpu_torch.parallel.runner import make_runner
    from distrifuser_tpu_torch.schedulers import get_scheduler
    from distrifuser_tpu_torch.utils.config import DistriConfig

    inp = torch.load(in_path)
    ucfg = unet.tiny_config(cross_attention_dim=32)
    out = {}
    for i, (fields, images) in enumerate(inp["runs"]):
        cfg = DistriConfig(device="cpu", height=128, width=128, warmup_steps=1, **fields)
        runner = make_runner(cfg, ucfg, inp["params"], get_scheduler("ddim"))
        seen = []
        x = runner.generate(inp["latents"][images], inp["enc"][:, images],
                            num_inference_steps=4, guidance_scale=5.0,
                            callback=lambda i, t, x: seen.append(tuple(x.shape)))
        out[("run", i)] = (x, seen, dict(runner.phase_counts))
    for i, (fields, prompts, images) in enumerate(inp["pipelines"]):
        cfg = DistriConfig(device="cpu", height=128, width=128, warmup_steps=1,
                           use_cuda_graph=False, **fields)
        pipe = _tiny_sd_pipeline(cfg, inp["vae"])
        kw = dict(latents=inp["latents"][images], num_inference_steps=3)
        out[("pipeline", i)] = tuple(
            torch.stack([torch.from_numpy(im) for im in pipe(prompts, output_type=kind,
                                                              **kw).images])
            for kind in ("latent", "np"))
    torch.save(out, f"{out_path}.rank{rank}")


def overlap_worker(rank, world, in_path, out_path):
    """The tiny SD runner (4 DDIM steps, warmup 1: two synchronous and two
    stale evaluations) in each case of ``cases`` (config fields) with every
    evaluation's collectives recorded (parallel/overlap.py).  Saves {case:
    [(phase, [collective as a dict, ...]), ...]}."""
    from distrifuser_tpu_torch.models import unet
    from distrifuser_tpu_torch.parallel import overlap
    from distrifuser_tpu_torch.parallel.runner import make_runner
    from distrifuser_tpu_torch.schedulers import get_scheduler
    from distrifuser_tpu_torch.utils.config import DistriConfig

    inp = torch.load(in_path)
    ucfg = unet.tiny_config(cross_attention_dim=32)
    out = {}
    for case in inp["cases"]:
        cfg = DistriConfig(device="cpu", height=128, width=128, warmup_steps=1,
                           use_cuda_graph=False, **case)
        runner = make_runner(cfg, ucfg, inp["params"], get_scheduler("ddim"))
        with overlap.record() as evaluations:
            runner.generate(inp["latents"], inp["enc"], num_inference_steps=4,
                            guidance_scale=5.0)
        out[tuple(sorted(case.items()))] = [
            (e.phase, [c.as_dict() for c in e.collectives]) for e in evaluations]
    torch.save(out, f"{out_path}.rank{rank}")


def dit_worker(rank, world, in_path, out_path):
    """The tiny DiT runner (parallel/dit_sp.py) in each case of ``cases``
    (config fields over ``base``): ``steps`` steps from the same latents,
    caption states and mask, with the latent shapes its callback saw; then each case
    of ``graphed`` with ``use_cuda_graph=True``.  Saves {case index, or
    ("graphed", index): (latent, comm_report(1), comm_report(2), phase
    counts, callback shapes), and ("extra", either): its
    ``_transformer_extras``}."""
    from distrifuser_tpu_torch.models import dit
    from distrifuser_tpu_torch.parallel.collectives import all_to_all
    from distrifuser_tpu_torch.parallel.dit_sp import DiTDenoiseRunner
    from distrifuser_tpu_torch.schedulers import get_scheduler
    from distrifuser_tpu_torch.utils.config import DistriConfig

    inp = torch.load(in_path)
    dcfg = dit.tiny_dit_config(depth=2)
    out = {}
    runs = [(i, case, {}) for i, case in enumerate(inp["cases"])]
    runs += [(("graphed", i), case, {"use_cuda_graph": True})
             for i, case in enumerate(inp.get("graphed", []))]
    for i, case, extra in runs:
        fields = {**inp["base"], **case, **extra}
        batch = fields.get("batch_size", 1)
        cfg = DistriConfig(device="cpu", height=128, width=128, **fields)
        runner = DiTDenoiseRunner(cfg, dcfg, inp["params"], get_scheduler(inp["scheduler"]))
        seen, a2a = [], all_to_all.launches
        x = runner.generate(inp["latents"][:batch], inp["enc"][:, :batch],
                            guidance_scale=4.5, num_inference_steps=inp["steps"],
                            cap_mask=inp["mask"][:, :batch],
                            callback=lambda i, t, x: seen.append(tuple(x.shape)))
        out[i] = (x, runner.comm_report(1), runner.comm_report(2),
                  dict(runner.phase_counts), seen)
        out["extra", i] = _transformer_extras(runner, inp["steps"], a2a)
    torch.save(out, f"{out_path}.rank{rank}")


def _transformer_extras(runner, steps, a2a_before):
    """What a transformer runner's case saves besides its latent: the
    pipelines' ``comm_plan`` of its config at 1 and 2 images, the bytes
    each phase's refreshes put on the wire by buffer, and the all-to-alls
    its run issued."""
    import types

    from distrifuser_tpu_torch.parallel.collectives import all_to_all
    from distrifuser_tpu_torch.pipelines import DistriPixArtPipeline

    stub = types.SimpleNamespace(distri_config=runner.cfg, runner=runner)
    return {"plan": DistriPixArtPipeline.comm_plan(stub, steps),
            "wire": runner.refresh_wire, "a2a": all_to_all.launches - a2a_before}


def mmdit_worker(rank, world, in_path, out_path):
    """The tiny MMDiT runner (parallel/mmdit_sp.py) in each case of ``cases``
    (config fields over ``base``; a case's "model" names its MMDiT in
    ``models``, config fields and tree): ``steps`` flow-euler steps from the
    same latents, text states and pooled vectors, with the latent shapes its
    callback saw; then each case of ``graphed`` with ``use_cuda_graph=True``.
    Saves {case index, or ("graphed", index): (latent, comm_report(1),
    comm_report(2), phase counts, callback shapes), and ("extra", either):
    its ``_transformer_extras``}."""
    import dataclasses

    from distrifuser_tpu_torch.models import mmdit
    from distrifuser_tpu_torch.parallel.collectives import all_to_all
    from distrifuser_tpu_torch.parallel.mmdit_sp import MMDiTDenoiseRunner
    from distrifuser_tpu_torch.schedulers import get_scheduler
    from distrifuser_tpu_torch.utils.config import DistriConfig

    inp = torch.load(in_path)
    out = {}
    runs = [(i, case, {}) for i, case in enumerate(inp["cases"])]
    runs += [(("graphed", i), case, {"use_cuda_graph": True})
             for i, case in enumerate(inp.get("graphed", []))]
    for i, case, extra in runs:
        fields = {**inp["base"], **case, **extra}
        fields_model, params = inp["models"][fields.pop("model", "plain")]
        mcfg = dataclasses.replace(mmdit.tiny_mmdit_config(), **fields_model)
        batch = fields.get("batch_size", 1)
        cfg = DistriConfig(device="cpu", height=256, width=256, **fields)
        runner = MMDiTDenoiseRunner(cfg, mcfg, params, get_scheduler("flow-euler"))
        seen, a2a = [], all_to_all.launches
        x = runner.generate(inp["latents"][:batch], inp["enc"][:, :batch],
                            inp["pooled"][:, :batch], guidance_scale=7.0,
                            num_inference_steps=inp["steps"],
                            callback=lambda i, t, x: seen.append(tuple(x.shape)))
        out[i] = (x, runner.comm_report(1), runner.comm_report(2),
                  dict(runner.phase_counts), seen)
        out["extra", i] = _transformer_extras(runner, inp["steps"], a2a)
    torch.save(out, f"{out_path}.rank{rank}")


def pipefusion_worker(rank, world, in_path, out_path):
    """The tiny DiT's PipeFusion runner (parallel/pipefusion.py) in each case
    of ``cases`` (config fields; "depth", "steps", "scheduler", "batch",
    "gs" and "weight_quant" of the run): the final latent from the same
    latents, caption states and mask.  Saves {case index: (latent,
    comm_report(1), comm_report(2), tick counts, the pipelines'
    ``comm_plan`` of the config)} and {("refusal", i): the exception type
    name and message of ``refusals[i]`` (config fields, fields replaced in
    the depth-4 tiny DiT's config), or None}; with ``patch_report`` (a
    case), {"patch_report": the displaced DiT runner's ``comm_report`` of
    its config}."""
    import dataclasses
    import types

    from distrifuser_tpu_torch.models import dit
    from distrifuser_tpu_torch.models.weights import quantize_params
    from distrifuser_tpu_torch.parallel.dit_sp import DiTDenoiseRunner
    from distrifuser_tpu_torch.parallel.pipefusion import PipeFusionRunner
    from distrifuser_tpu_torch.pipelines import DistriPixArtPipeline
    from distrifuser_tpu_torch.schedulers import get_scheduler
    from distrifuser_tpu_torch.utils.config import DistriConfig

    inp = torch.load(in_path)
    out = {}
    for i, case in enumerate(inp["cases"]):
        fields = dict(case)
        run = {k: fields.pop(k) for k in ("depth", "steps", "scheduler", "batch", "gs",
                                          "weight_quant") if k in fields}
        batch = run.get("batch", 1)
        cfg = DistriConfig(device="cpu", height=128, width=128, parallelism="pipefusion",
                           batch_size=batch, weight_quant=run.get("weight_quant", "none"),
                           **fields)
        params = inp["params"][run["depth"]]
        if cfg.weight_quant != "none":
            params = quantize_params(params, cfg.weight_quant, compute=cfg.quant_compute)
        runner = PipeFusionRunner(cfg, dit.tiny_dit_config(depth=run["depth"]), params,
                                  get_scheduler(run["scheduler"]))
        x = runner.generate(inp["latents"][:batch], inp["enc"][:, :batch],
                            guidance_scale=run["gs"], num_inference_steps=run["steps"],
                            cap_mask=inp["mask"][:, :batch])
        stub = types.SimpleNamespace(distri_config=cfg, runner=runner)
        out[i] = (x, runner.comm_report(1), runner.comm_report(2), dict(runner.tick_counts),
                  DistriPixArtPipeline.comm_plan(stub, run["steps"]))
    if inp.get("patch_report") is not None:
        fields = {k: v for k, v in inp["patch_report"].items()
                  if k not in ("depth", "steps", "scheduler", "gs")}
        cfg = DistriConfig(device="cpu", height=128, width=128, **fields)
        out["patch_report"] = DiTDenoiseRunner(
            cfg, dit.tiny_dit_config(depth=4), inp["params"][4],
            get_scheduler("ddim")).comm_report()
    for i, (fields, dit_fields) in enumerate(inp.get("refusals", [])):
        dcfg = dataclasses.replace(dit.tiny_dit_config(depth=4), **dit_fields)
        try:
            cfg = DistriConfig(device="cpu", height=fields.pop("height", 128),
                               width=fields.pop("width", 128), parallelism="pipefusion",
                               **fields)
            # a changed DiT has no weights: the runner must refuse it first
            PipeFusionRunner(cfg, dcfg, None if dit_fields else inp["params"][4],
                             get_scheduler("ddim"))
            out["refusal", i] = None
        except (ValueError, NotImplementedError) as e:
            out["refusal", i] = (type(e).__name__, str(e))
    torch.save(out, f"{out_path}.rank{rank}")


# -- serving over n ranks (serve/ranks.py) -------------------------------------


class _deadline:
    """A case's own time limit on one rank: past ``seconds`` the rank says
    which case hung and exits, so a deadlock fails the spawn instead of
    hanging the test run."""

    def __init__(self, seconds, what):
        import threading

        self.timer = threading.Timer(seconds, self._expire, args=(what, seconds))
        self.timer.daemon = True

    @staticmethod
    def _expire(what, seconds):
        import sys

        print(f"{what} did not finish within {seconds} s", file=sys.stderr, flush=True)
        os._exit(3)

    def __enter__(self):
        self.timer.start()

    def __exit__(self, *exc):
        self.timer.cancel()


def _fake_config(**kw):
    from distrifuser_tpu_torch.serve import ServeConfig

    kw.setdefault("buckets", ((64, 64),))
    kw.setdefault("warmup_buckets", ((64, 64),))
    kw.setdefault("max_batch_size", 2)
    kw.setdefault("batch_window_s", 0.05)
    kw.setdefault("default_steps", 4)
    return ServeConfig(**kw)


def _fake_serve(groups, world, config, requests, *, fault_plan=None, factory_kw=None,
                during=None):
    """One fake-executor server over the ranks: rank 0 submits ``requests``
    ((prompt, seed, submit keywords)) and returns its results' records and
    health; every rank returns its log and built keys.  ``during(server)``
    runs on rank 0 after the submissions and returns more (prompt, seed,
    future) triples."""
    from distrifuser_tpu_torch.serve import serve_over_ranks
    from distrifuser_tpu_torch.serve.testing import CollectiveFakeExecutorFactory, fake_image

    fac = CollectiveFakeExecutorFactory(groups, **(factory_kw or {}))
    server = serve_over_ranks(fac, config, fault_plan=fault_plan,
                              mesh_plan=f"dp1.cfg1.sp{world}")
    out = {}
    if server is not None:
        with server:
            subs = [(prompt, seed, server.submit(prompt, height=64, width=64, seed=seed,
                                                 **kw))
                    for prompt, seed, kw in requests]
            if during is not None:
                subs += during(server)
            records = []
            for prompt, seed, fut in subs:
                try:
                    r = fut.result(timeout=60)
                except Exception as exc:  # noqa: BLE001 -- the record says which
                    records.append({"error": type(exc).__name__, "text": str(exc)})
                    continue
                key = next(k for k in fac.built if k.short() == r.exec_key)
                records.append({"ok": bool(np.array_equal(r.output,
                                                          fake_image(prompt, seed, key))),
                                "batch_size": r.batch_size, "exec_key": r.exec_key,
                                "retries": r.retries, "preempts": r.preempts,
                                "degradations": list(r.degradations)})
            out["health"] = server.health()
            out["metrics"] = {k: v for k, v in server.metrics_snapshot().items()
                              if k in ("requests", "staging", "step_batching")}
        out["records"] = records
        out["health_after"] = server.health()
        out["peak"] = fac.tracker.peak
    out["log"] = sorted(fac.log)
    out["built"] = [k.short() for k in fac.built]
    return out


def _evict_drop_case(rank, world, groups):
    """A cache of one executor serving two buckets in turn (each eviction
    a one-way command: every follower drops its executor), then a staged
    batch whose denoise fails on rank 0 after the followers ran it (the
    followers drop its work when it leaves rank 0's pipeline), then one
    whose encode fails on rank 0 after the followers ran it (they drop the
    work that rank 0 never got)."""
    from distrifuser_tpu_torch.serve import RankFollower, serve_over_ranks
    from distrifuser_tpu_torch.serve.testing import CollectiveFakeExecutorFactory, fake_image
    from distrifuser_tpu_torch.utils.config import control_group

    staged = _fake_config(pipeline_stages=True, max_batch_size=1)
    cases = ((_fake_config(buckets=((64, 64), (128, 128)), warmup_buckets=(),
                           cache_capacity=1), [64, 128, 64], {}),
             (staged, [64, 64], {"fail_stage": "denoise", "fail_times": 1}),
             (staged, [64, 64], {"fail_stage": "encode", "fail_times": 1}))
    out = {"evicted": 0, "dropped": 0, "records": []}
    for config, hw, fail in cases:
        fac = CollectiveFakeExecutorFactory(groups, **(fail if rank == 0 else {}))
        if fail and rank == 0:
            # only the first executor fails: a denoise that fails on rank 0
            # after its go aborts the data groups, and the executor their
            # rebuild makes serves the next batch
            make = fac._new_executor

            def first_fails(key, _make=make, _fac=fac):
                ex = _make(key)
                _fac.fail_stage = None
                return ex

            fac._new_executor = first_fails
        if rank:
            follower = RankFollower(control_group(), fac)
            follower.run()
            out["evicted"] += follower.evicted
            out["dropped"] += follower.dropped
            continue
        server = serve_over_ranks(fac, config, mesh_plan=f"dp1.cfg1.sp{world}")
        with server:
            for i, size in enumerate(hw):
                fut = server.submit(f"e{i}", height=size, width=size, seed=i)
                try:
                    r = fut.result(timeout=60)
                    key = next(k for k in fac.built if k.short() == r.exec_key)
                    out["records"].append(
                        np.array_equal(r.output, fake_image(f"e{i}", i, key)))
                except Exception as exc:  # noqa: BLE001 -- the record says which
                    out["records"].append(type(exc).__name__)
        out.setdefault("evictions", []).append(server.cache.stats()["evictions"])
    return out


def _serve_fake_cases(rank, world, groups):
    from distrifuser_tpu_torch.serve import (FaultPlan, FaultRule, ResilienceConfig,
                                             StepBatchConfig)

    out = {}
    reqs = [(f"p{i}", i, {}) for i in range(3)]
    with _deadline(60, f"whole-batch at world {world}"):
        out["whole"] = _fake_serve(groups, world, _fake_config(), reqs)
    with _deadline(60, f"staged at world {world}"):
        out["staged"] = _fake_serve(
            groups, world, _fake_config(pipeline_stages=True, max_inflight_batches=2,
                                        max_batch_size=1),
            [(f"s{i}", 10 + i, {}) for i in range(5)],
            factory_kw={"encode_s": 0.01, "denoise_s": 0.04, "decode_s": 0.04})

    def join_late(server):
        # the second request joins the first's cohort a few rounds in
        while server.stepbatch.rounds < 3:
            time.sleep(0.002)
        return [("late", 9, server.submit("late", height=64, width=64, seed=9))]

    step_cfg = _fake_config(default_steps=8, step_batching=StepBatchConfig(
        enabled=True, slots=2, preview_interval=0))
    with _deadline(60, f"step rounds with a join at world {world}"):
        res = _fake_serve(groups, world, step_cfg, [("early", 8, {})],
                          factory_kw={"step_time_s": 0.005}, during=join_late)
        out["step_join"] = res
    # a preemption: one slot, a slack request of SLACK_STEPS running, a
    # tight one of 16 arriving whose time to live fits its own steps at the
    # calibrated per-step estimate but not those plus half the slack one's
    # rest (the window in the middle, whatever the ranks' step time on a
    # loaded machine: the slack one's length keeps the estimate free to
    # move by -34% to +110% between the arrival and the round that preempts)
    pre_cfg = _fake_config(default_steps=16, step_batching=StepBatchConfig(
        enabled=True, slots=1, preview_interval=0))

    def tight_arrives(server):
        sb = server.stepbatch
        while sb.rounds < 3:
            time.sleep(0.002)
        (state,) = sb.occupied()
        ttl = sb.per_step_s() * (16 + state.remaining / 2)
        return [("tight", 2, server.submit("tight", height=64, width=64, seed=2,
                                           ttl_s=ttl))]

    with _deadline(60, f"step rounds with a preemption at world {world}"):
        slack = [("slack", 1, {"num_inference_steps": SLACK_STEPS})]
        out["step_preempt"] = _fake_serve(groups, world, pre_cfg, slack,
                                          factory_kw={"step_time_s": 0.02},
                                          during=tight_arrives)
    if world != 2:
        return out
    with _deadline(60, f"evictions and dropped works at world {world}"):
        out["evict_drop"] = _evict_drop_case(rank, world, groups)
    # a failure on rank 1 only: retryable (one retry), then OOM-like (the
    # ladder's weight_quant_on rung rebuilds the int8 key on every rank)
    res_cfg = ResilienceConfig(allow_batch_split=False, allow_stepwise_fallback=False,
                               allow_weight_quant_on=True, backoff_base_s=0.001,
                               backoff_max_s=0.01)
    for name, kind in (("follower_execute_error", "execute_error"),
                       ("follower_oom", "oom")):
        plan = (FaultPlan([FaultRule(site="execute", kind=kind, at_calls=(0,))])
                if rank == 1 else None)
        with _deadline(60, f"{name} at world {world}"):
            out[name] = _fake_serve(groups, world, _fake_config(resilience=res_cfg),
                                    [("f", 5, {})], fault_plan=plan)
    out.update(_fault9_cases(rank, world, groups))
    return out


# the preempted request's steps in the step_preempt case (the tight one runs 16)
SLACK_STEPS = 40

# the watchdog bound of the fault-9 cases: their gloo data groups time out
# after as long (utils.config.data_group_timeout)
WATCHDOG_S = 2.0


def _after_rebuild(prompt, seed):
    """A ``during`` of `_fake_serve`: one more request, submitted once the
    server over the ranks has rebuilt its data groups (or its first
    request failed for good)."""

    def during(server):
        deadline = time.monotonic() + 30
        while (server.health()["ranks"]["rebuilds"] < 1
               and server.health()["requests"]["failed_execute"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        return [(prompt, seed, server.submit(prompt, height=64, width=64, seed=seed))]

    return during


def _fault9_cases(rank, world, groups):
    """A failure on rank 1 alone inside an operation (queue 3 fault 9):
    the collective fake raises (or sleeps) on rank 1 between its two group
    operations, while rank 0 waits in the second (gloo: until the data
    groups' timeout, the watchdog bound); and a hang on rank 1 before
    the go, past rank 0's watchdog.  Each case records every rank's data
    group generation before and after (every case at one watchdog bound,
    whose data groups are made first, so that only a fault rebuilds)."""
    from distrifuser_tpu_torch.serve import FaultPlan, FaultRule, ResilienceConfig
    from distrifuser_tpu_torch.utils.config import (data_group_generation,
                                                    rebuild_data_groups,
                                                    set_data_group_watchdog)

    if set_data_group_watchdog(WATCHDOG_S):
        rebuild_data_groups()

    def in_op(kind, **rule):
        return {"fault_plan": FaultPlan([FaultRule(site="collective", kind=kind,
                                                   at_calls=(0,), **rule)])
                if rank == 1 else None}

    res = dict(allow_batch_split=False, allow_stepwise_fallback=False,
               allow_weight_quant_on=True, backoff_base_s=0.001, backoff_max_s=0.01)
    cases = (
        # an error between the two group operations: retried after the rebuild
        ("inop_error", ResilienceConfig(watchdog_timeout_s=WATCHDOG_S, **res),
         in_op("execute_error"), None),
        # an out-of-memory there: the ladder's weight_quant_on on every rank
        ("inop_oom", ResilienceConfig(watchdog_timeout_s=WATCHDOG_S, **res),
         in_op("oom"), None),
        # a hang there past the watchdog bound: rank 0 leaves its collective
        # through the group's timeout, rank 1's lane is abandoned
        ("inop_hang", ResilienceConfig(watchdog_timeout_s=WATCHDOG_S, **res),
         in_op("hang", hang_s=1.5 * WATCHDOG_S), None),
        # a hang before the go, past rank 0's watchdog: the watchdog
        # abandons the command, the server keeps serving
        ("follower_hang", ResilienceConfig(watchdog_timeout_s=WATCHDOG_S, max_retries=0),
         {}, FaultPlan([FaultRule(site="execute", kind="hang", at_calls=(0,),
                                  hang_s=1.5 * WATCHDOG_S)]) if rank == 1 else None),
    )
    out = {}
    for name, res_cfg, factory_kw, plan in cases:
        before = data_group_generation()
        with _deadline(60, f"{name} at world {world}"):
            out[name] = _fake_serve(groups, world, _fake_config(resilience=res_cfg),
                                    [("f", 5, {})], fault_plan=plan,
                                    factory_kw=factory_kw, during=_after_rebuild("g", 6))
        out[name]["generations"] = (before, data_group_generation())
    return out


def _seeded_latents(seeds, shape=(1, 16, 16, 4)):
    """Every request's initial latent from numpy seeded by its seed: what
    the tests hand the port's executors and the JAX package's alike."""
    return torch.from_numpy(np.concatenate(
        [np.random.RandomState(int(s)).randn(*shape).astype(np.float32) for s in seeds]))


def _ranked_factory(build, pipes):
    """`pipeline_executor_factory` over ``build(key)`` whose executors draw
    `_seeded_latents`; ``pipes`` keeps each key's last pipeline (a rebuild
    of the data groups builds the key's pipeline anew, on the new groups)."""
    from distrifuser_tpu_torch.serve import pipeline_executor_factory

    def build_kept(key):
        pipes[key] = build(key)
        return pipes[key]

    inner = pipeline_executor_factory(build_kept)

    def factory(key):
        ex = inner(key)
        ex._draw_latents = _seeded_latents
        return ex

    return factory


def _tiny_sdxl_pipeline(inp, **fields):
    from distrifuser_tpu_torch import DistriConfig, DistriSDXLPipeline
    from distrifuser_tpu_torch.models import clip, unet, vae

    tcfgs = [clip.tiny_clip_config(hidden=16),
             clip.CLIPTextConfig(vocab_size=1000, hidden_size=16, num_hidden_layers=2,
                                 num_attention_heads=4, intermediate_size=32,
                                 projection_dim=32)]
    cfg = DistriConfig(device="cpu", height=128, width=128, warmup_steps=1, batch_size=2,
                       **fields)
    return DistriSDXLPipeline.from_params(
        cfg, unet.tiny_config(cross_attention_dim=32, sdxl=True), inp["unet"],
        vae.tiny_vae_config(), inp["vae"], tcfgs, inp["text"])


def _serve_sdxl_cases(rank, world, inp):
    """The tiny SDXL pipeline at sp ``world`` (CFG folded, warmup 1, 3 DDIM
    steps) behind a server over the ranks: whole-batch, staged, and step
    batching whose server stops at step 1 and exports its carry, imported
    by a second server; then every rank's solo calls."""
    from distrifuser_tpu_torch.serve import (CarryExportedError, InferenceServer,
                                             ServeConfig, StepBatchConfig,
                                             serve_over_ranks)
    from distrifuser_tpu_torch.serve.testing import StepFakeExecutorFactory

    steps, requests = inp["steps"], inp["requests"]
    pipes = {}
    factory = _ranked_factory(lambda key: _tiny_sdxl_pipeline(inp, split_batch=False),
                              pipes)
    mesh = f"dp1.cfg1.sp{world}"
    base = dict(buckets=((128, 128),), max_batch_size=2, batch_window_s=0.3,
                default_steps=steps, warmup_buckets=((128, 128),))
    out = {}
    for name, fields in (("sdxl_whole", {}),
                         ("sdxl_staged", {"pipeline_stages": True,
                                          "max_inflight_batches": 2})):
        with _deadline(120, f"tiny SDXL {name} at world {world}"):
            server = serve_over_ranks(factory, ServeConfig(**base, **fields), mesh_plan=mesh)
            if server is not None:
                with server:
                    futs = [server.submit(p, height=128, width=128, seed=s)
                            for p, s in requests]
                    res = [f.result(timeout=120) for f in futs]
                out[name] = {"images": [r.output for r in res],
                             "batch_sizes": [r.batch_size for r in res],
                             "staging": server.metrics_snapshot()["staging"]}
    with _deadline(120, f"tiny SDXL with a failure inside a call at world {world}"):
        out["sdxl_inop"] = _sdxl_failure_inside_a_call(rank, world, inp, factory, base)
    # step batching: the first server stops itself at step 1 (a preview
    # callback on its scheduler thread), exporting the carry from every rank
    step_cfg = ServeConfig(**dict(base, warmup_buckets=()), step_batching=StepBatchConfig(
        enabled=True, slots=2, preview_interval=1))
    prompt, seed = requests[0]
    with _deadline(120, f"tiny SDXL carry export at world {world}"):
        server = serve_over_ranks(factory, step_cfg, mesh_plan=mesh)
        if server is not None:
            def stop_at_step_one(step, total, preview):
                if step == 1:
                    server.request_stop()

            with server:
                fut = server.submit(prompt, height=128, width=128, seed=seed,
                                    on_progress=stop_at_step_one)
                try:
                    fut.result(timeout=120)
                    snapshot = None
                except CarryExportedError as exc:
                    snapshot = exc.snapshot
                    out["exported_at"] = exc.steps_done
    with _deadline(120, f"tiny SDXL carry import at world {world}"):
        server = serve_over_ranks(factory, step_cfg, mesh_plan=mesh)
        if server is not None:
            from distrifuser_tpu_torch.serve import decode_snapshot

            out["snapshot_meta"] = {k: v for k, v in decode_snapshot(snapshot).meta.items()
                                    if k in ("step", "rank_leaves", "exec_key")}
            with server:
                r = server.submit(prompt, height=128, width=128, seed=seed,
                                  carry_snapshot=snapshot).result(timeout=120)
            out["migrated"] = {"image": r.output, "migrations": r.migrations,
                               "steps_salvaged": r.steps_salvaged}
            # a server on one rank refuses the envelope of two, typed
            one = InferenceServer(StepFakeExecutorFactory(), step_cfg)
            with one:
                fut = one.submit(prompt, height=128, width=128, seed=seed,
                                 carry_snapshot=snapshot)
                try:
                    fut.result(timeout=60)
                    out["one_rank"] = None
                except Exception as exc:  # noqa: BLE001 -- the record says which
                    out["one_rank"] = (type(exc).__name__, str(exc))
    # the SLO controller's tiers over the ranks: each tier's key (its step
    # cache, wire compression, partial refresh, steps) built by a function
    # that reads the knobs, one request at 4 steps
    from distrifuser_tpu_torch.serve import DEFAULT_TIERS, ExecKey, apply_tier

    tier_pipes = {}
    tier_factory = _ranked_factory(lambda key: _tiny_sdxl_pipeline(
        inp, split_batch=False, step_cache_interval=key.step_cache_interval,
        step_cache_depth=key.step_cache_depth, comm_compress=key.comm_compress,
        refresh_fraction=key.refresh_fraction), tier_pipes)
    base_key = ExecKey(model_id="model", scheduler="ddim", height=128, width=128,
                       steps=4, cfg=True, mesh_plan=mesh)
    tiers = {}
    for tier in DEFAULT_TIERS:
        key = apply_tier(base_key, tier)
        knobs = {f: getattr(key, f) for f in ("step_cache_interval", "step_cache_depth",
                                              "comm_compress", "refresh_fraction")}
        with _deadline(120, f"tiny SDXL tier {tier.name} at world {world}"):
            server = serve_over_ranks(tier_factory, ServeConfig(
                **dict(base, default_steps=key.steps), **knobs), mesh_plan=mesh)
            if server is not None:
                with server:
                    r = server.submit(prompt, height=128, width=128,
                                      seed=seed).result(timeout=120)
                tiers[tier.name] = {"image": r.output, "exec_key": r.exec_key}
        with _deadline(120, f"tiny SDXL tier {tier.name} solo call at world {world}"):
            pipe = tier_pipes[key]
            solo_image = pipe(prompt, latents=_seeded_latents([seed]),
                              num_inference_steps=key.steps, output_type="np").images[0]
            if tier.name in tiers:
                tiers[tier.name]["solo"] = solo_image
                if tier.name in ("full", "comm_compress", "partial_refresh"):
                    # the wire bytes a step by phase (every phase ran)
                    tiers[tier.name]["comm_plan"] = pipe.comm_plan(key.steps)
    out["tiers"] = tiers
    # the solo calls, on every rank (each is collective)
    with _deadline(120, f"tiny SDXL solo calls at world {world}"):
        solo = {}
        for key, pipe in pipes.items():
            mode = key.exec_mode
            solo[mode] = [pipe(p, latents=_seeded_latents([s]), num_inference_steps=steps,
                               output_type="np").images[0] for p, s in requests]
        out["solo"] = solo
    return out


class _FailsOnce:
    """An executor whose first whole-batch call raises on this rank after
    the pipeline issued ``after`` all-gathers, between two collectives of
    its denoise (``torch.distributed.all_gather`` patched for that call);
    anything else is the wrapped executor's."""

    armed = True

    def __init__(self, ex, after):
        self._ex = ex
        self._after = after

    def __getattr__(self, name):
        return getattr(self._ex, name)

    def __call__(self, *args):
        if not _FailsOnce.armed:
            return self._ex(*args)
        _FailsOnce.armed = False
        real, seen = dist.all_gather, [0]

        def all_gather(*a, **kw):
            seen[0] += 1
            if seen[0] > self._after:
                raise RuntimeError("injected failure between two collectives")
            return real(*a, **kw)

        dist.all_gather = all_gather
        try:
            return self._ex(*args)
        finally:
            dist.all_gather = real


def _sdxl_failure_inside_a_call(rank, world, inp, factory, base):
    """The tiny SDXL pipeline over the ranks, whole-batch, at a watchdog
    bound of ``SDXL_WATCHDOG_S``: the first call raises on rank 1 alone in
    the middle of its denoise, after three all-gathers, while rank 0 runs on
    into the next collective.  The server aborts and rebuilds the data
    groups on both ranks, the retry builds the key's pipeline anew, and the
    two requests' images come back (test: the solo call's bits)."""
    from distrifuser_tpu_torch.serve import ResilienceConfig, ServeConfig, serve_over_ranks
    from distrifuser_tpu_torch.utils.config import (data_group_generation,
                                                    rebuild_data_groups,
                                                    set_data_group_watchdog)

    if set_data_group_watchdog(SDXL_WATCHDOG_S):
        rebuild_data_groups()
    before = data_group_generation()
    wrapped = factory if rank != 1 else (lambda key: _FailsOnce(factory(key), after=3))
    server = serve_over_ranks(wrapped, ServeConfig(**dict(base, max_batch_size=1),
                                                   resilience=ResilienceConfig(
                                                       watchdog_timeout_s=SDXL_WATCHDOG_S)),
                              mesh_plan=f"dp1.cfg1.sp{world}")
    out = {}
    if server is not None:
        with server:
            res = [server.submit(p, height=128, width=128, seed=s).result(timeout=120)
                   for p, s in inp["requests"][:2]]
            out = {"images": [r.output for r in res], "retries": [r.retries for r in res],
                   "health": server.health()}
    out["generations"] = (before, data_group_generation())
    return out


# the watchdog bound of the tiny SDXL failure case: a healthy call takes a
# fraction of it on a loaded CPU, and rank 0 waits as long in the
# collective rank 1 never enters
SDXL_WATCHDOG_S = 8.0


def serve_ranks_worker(rank, world, in_path, out_path):
    """Serving over the ranks: the collective fakes' cases
    (``_serve_fake_cases``), then the tiny SDXL pipeline's
    (``_serve_sdxl_cases``).  Saves {case: record} (rank 0's records hold
    its outputs)."""
    from distrifuser_tpu_torch.serve.testing import fake_groups

    inp = torch.load(in_path)
    groups = fake_groups()
    out = _serve_fake_cases(rank, world, groups)
    out.update(_serve_sdxl_cases(rank, world, inp))
    torch.save(out, f"{out_path}.rank{rank}")


def _tiny_sd_stepwise(inp, world):
    """The tiny SD pipeline (the JAX package's ``build_sd_pipeline``
    shapes) at ``world`` ranks, CFG split x sp world/2, warmup 1, batch_size
    2, from the input's trees."""
    from distrifuser_tpu_torch import DistriConfig, DistriSDPipeline
    from distrifuser_tpu_torch.models import clip, unet, vae

    cfg = DistriConfig(device="cpu", height=128, width=128, warmup_steps=1, batch_size=2)
    return DistriSDPipeline.from_params(
        cfg, unet.tiny_config(cross_attention_dim=32), inp["unet"], vae.tiny_vae_config(),
        inp["vae"], [clip.tiny_clip_config(hidden=32)], [inp["text"]])


def _mixed_signature_drive(rank, world, inp):
    """tests/test_stepbatch.py ``test_real_pipeline_mixed_signature_groups``
    through a `RankedExecutor` on rank 0 (every other rank a `RankFollower`):
    three requests' solo step runs, then a at step 2 (its next step stale)
    stepped together with the fresh b and c (two dispatches, three packed
    rows), then b and c packed twice more."""
    from distrifuser_tpu_torch.serve import ExecKey, RankFollower, RankLeader
    from distrifuser_tpu_torch.utils.config import control_group

    steps, pipes = inp["steps"], {}
    factory = _ranked_factory(lambda key: _tiny_sd_stepwise(inp, world), pipes)
    group = control_group()
    if rank:
        RankFollower(group, factory).run()
        return {}
    leader = RankLeader(group, world)
    key = ExecKey(model_id="tiny-sd", scheduler="ddim", height=128, width=128, steps=steps,
                  cfg=True, mesh_plan="dp1.cfg2.sp2", exec_mode="step")
    ex = leader.factory(factory)(key)
    out = {"is_sp": pipes[key].distri_config.is_sp}

    def solo_image(prompt, seed):
        w = ex.step_begin(prompt, "", seed, 5.0)
        for _ in range(steps):
            ex.step_run([w])
        return np.asarray(ex.step_finish(w))

    out["refs"] = [solo_image(p, s) for p, s in inp["requests"]]
    (pa, sa), (pb, sb), (pc, sc) = inp["requests"]
    wa = ex.step_begin(pa, "", sa, 5.0)
    ex.step_run([wa])
    ex.step_run([wa])
    wb, wc = ex.step_begin(pb, "", sb, 5.0), ex.step_begin(pc, "", sc, 5.0)
    out["signatures"] = [ex.step_signature(w) is not None for w in (wa, wb, wc)]
    out["sig_a_differs"] = ex.step_signature(wa) != ex.step_signature(wb)
    out["sig_bc_equal"] = ex.step_signature(wb) == ex.step_signature(wc)
    ex.step_run([wa, wb, wc])
    out["stats_mixed"] = dict(ex.step_pack_stats)
    out["bc_shared"] = wb["carry"] is wc["carry"] and wa["carry"] is not wb["carry"]
    img_a = np.asarray(ex.step_finish(wa))
    ex.step_run([wb, wc])
    out["stats_2"] = dict(ex.step_pack_stats)
    ex.step_run([wb, wc])
    out["stats_3"] = dict(ex.step_pack_stats)
    out["images"] = [img_a, np.asarray(ex.step_finish(wb)), np.asarray(ex.step_finish(wc))]
    out["commands"] = leader.commands
    leader.close()
    return out


def step_ranks_worker(rank, world, in_path, out_path):
    """Serving over four ranks: the collective fakes' order cases, then the
    mixed-signature step drive of the tiny SD pipeline
    (``_mixed_signature_drive``).  Saves {case: record}."""
    from distrifuser_tpu_torch.serve.testing import fake_groups

    inp = torch.load(in_path)
    groups = fake_groups()
    out = _serve_fake_cases(rank, world, groups)
    with _deadline(180, f"the mixed-signature step drive at world {world}"):
        out["mixed"] = _mixed_signature_drive(rank, world, inp)
    with _deadline(60, f"a parked carry across a rebuild at world {world}"):
        out["step_fault"] = _parked_carry_across_rebuild(rank, world, groups)
    torch.save(out, f"{out_path}.rank{rank}")


def _parked_carry_across_rebuild(rank, world, groups):
    """Step batching over the ranks, one slot: a slack request runs, a
    tight one of 12 steps preempts it (its carry parks) and fails on rank
    1 alone between the two group operations of its ``step_begin``; the
    data groups are aborted and rebuilt on every rank, and the parked
    carry resumes on its key's rebuilt executor and finishes."""
    from distrifuser_tpu_torch.serve import (FaultPlan, FaultRule, ResilienceConfig,
                                             StepBatchConfig)
    from distrifuser_tpu_torch.utils.config import (data_group_generation,
                                                    rebuild_data_groups,
                                                    set_data_group_watchdog)

    if set_data_group_watchdog(WATCHDOG_S):
        rebuild_data_groups()
    plan = (FaultPlan([FaultRule(site="collective", kind="execute_error", p=1.0,
                                 max_fires=1, key_substr="@12st")])
            if rank == 1 else None)
    cfg = _fake_config(default_steps=16, step_batching=StepBatchConfig(
        enabled=True, slots=1, preview_interval=0),
        resilience=ResilienceConfig(watchdog_timeout_s=WATCHDOG_S))

    def tight_arrives(server):
        sb = server.stepbatch
        while sb.rounds < 3:
            time.sleep(0.002)
        (state,) = sb.occupied()
        ttl = sb.per_step_s() * (12 + state.remaining / 2)
        return [("tight", 2, server.submit("tight", height=64, width=64, seed=2,
                                           num_inference_steps=12, ttl_s=ttl))]

    before = data_group_generation()
    out = _fake_serve(groups, world, cfg, [("slack", 1, {})],
                      factory_kw={"step_time_s": 0.02, "fault_plan": plan},
                      during=tight_arrives)
    out["generations"] = (before, data_group_generation())
    return out
