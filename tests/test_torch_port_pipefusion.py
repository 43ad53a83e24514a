"""PyTorch port: PipeFusion (parallel/pipefusion.py) against the JAX
``PipeFusionRunner``, the cases of tests/test_pipefusion.py.

On gloo ranks (the workers of tests/test_torch_port_ranks.py) and on the
JAX package's fake CPU mesh of as many devices, from the same seeded tiny
DiT (depth 4), latents, caption states and caption mask, float32:

* at world 4: warmup only (every step the exact mega-patch, 4 stages, no
  CFG); the displaced stream with DDIM and with DPM-Solver (4 stages, 4
  chunks); the CFG split (CFG 2 x 2 stages); dp 2 x 2 stages (CFG folded,
  two images); ``full_sync``; int8_residual hops with the step cache at
  interval 2 and depth 1 stage (CFG folded); ``hybrid_loop`` (a knob with
  no effect in the port) against the JAX runner's hybrid and fused
  programs;
* at world 2: the CFG folded into the batch (2 stages); more chunks than
  stages (2 stages, 4 chunks, warmup 0);

each latent within rtol = atol = 5e-4 of the JAX one (compressed hops:
within 2e-2 of its largest magnitude, ``COMPRESSED_TOL``), the same on every
rank, ``comm_report`` at batch 1 and 2 and the pipelines' ``comm_plan``
equal to the JAX ones key for key, and each rank's tick passes those the
schedule derives; every JAX refusal reproduced with its exception type.
At one process: the JAX runner at one stage (four chunks), the callback
refusal, the in-place KV commit of ``dit_block``'s cache mode against the
copy it replaced, bit for bit, and ``DistriPixArtPipeline`` under
``parallelism="pipefusion"``.  One JAX compile a config, while the ranks
run.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu import pipelines as jax_pipelines
from distrifuser_tpu.models import dit as jax_dit
from distrifuser_tpu.models.weights import quantize_params as jax_quantize_params
from distrifuser_tpu.parallel.pipefusion import PipeFusionRunner as JaxPipeFusionRunner
from distrifuser_tpu.schedulers import get_scheduler as jax_scheduler
from distrifuser_tpu_torch.models import dit as port_dit
from distrifuser_tpu_torch.models import vae as port_vae
from distrifuser_tpu_torch.parallel.pipefusion import PipeFusionRunner
from distrifuser_tpu_torch.pipelines import DistriPixArtPipeline
from distrifuser_tpu_torch.schedulers import get_scheduler
from distrifuser_tpu_torch.utils.config import DistriConfig
from test_torch_port_dit_sp import _inputs
from test_torch_port_pixart import _seeded
from test_torch_port_ranks import pipefusion_worker, run_ranks

TOL = 5e-4
# compressed hops: the largest difference in units of the JAX latent's
# largest magnitude; a row that quantizes to the neighbouring int8 step in
# the other framework moves that row by 1/127 of its largest value
COMPRESSED_TOL = 2e-2
DEPTH = 4
NO_CFG = {"do_classifier_free_guidance": False, "split_batch": False}
RUN = {"depth": DEPTH, "scheduler": "ddim", "gs": 1.0}
WORLD4 = [
    {**RUN, **NO_CFG, "warmup_steps": 9, "steps": 3},  # warmup only
    {**RUN, **NO_CFG, "warmup_steps": 1, "steps": 6},
    {**RUN, **NO_CFG, "warmup_steps": 1, "steps": 6, "scheduler": "dpm-solver"},
    {**RUN, "warmup_steps": 1, "steps": 5, "gs": 3.5},  # CFG 2 x 2 stages
    {**RUN, "warmup_steps": 1, "steps": 4, "gs": 3.0, "dp_degree": 2, "batch": 2,
     "split_batch": False},  # dp 2 x 2 stages, CFG folded
    {**RUN, **NO_CFG, "warmup_steps": 1, "steps": 5, "mode": "full_sync"},
    {**RUN, "warmup_steps": 1, "steps": 6, "gs": 4.0, "split_batch": False,
     "comm_compress": "int8_residual", "step_cache_interval": 2,
     "step_cache_depth": 1},  # 4 stages, the last one deep
    {**RUN, "warmup_steps": 1, "steps": 5, "gs": 4.0, "split_batch": False,
     "scheduler": "dpm-solver", "hybrid_loop": True},
]
WORLD2 = [
    {**RUN, "warmup_steps": 1, "steps": 4, "gs": 3.5, "split_batch": False},  # folded
    {**RUN, **NO_CFG, "warmup_steps": 0, "steps": 4, "pipe_patches": 4},  # M > P
]
# (config fields, DiT config fields): each refused or accepted as the JAX
# runner at 4 devices does
REFUSALS = [
    ({**NO_CFG, "attn_impl": "ring"}, {}),
    ({**NO_CFG, "mode": "no_sync"}, {}),
    ({**NO_CFG, "use_cuda_graph": False}, {}),
    ({**NO_CFG, "step_cache_interval": 2, "step_cache_depth": 4}, {}),
    (NO_CFG, {"depth": 6}),
    ({**NO_CFG, "pipe_patches": 2}, {}),
    ({**NO_CFG, "pipe_patches": 5}, {}),
    (NO_CFG, {"hidden_size": 8, "num_heads": 1}),
    ({**NO_CFG, "height": 256, "width": 256}, {}),
    ({**NO_CFG, "comm_batch": True}, {}),
    ({**NO_CFG, "hybrid_loop": True, "step_cache_interval": 2, "step_cache_depth": 1},
     {}),
]


def _jax_fields(case):
    fields = {k: v for k, v in case.items()
              if k not in ("depth", "steps", "scheduler", "batch", "gs", "weight_quant")}
    return fields, case.get("batch", 1)


def jax_run(devices, case, params, inputs, **extra):
    """The JAX runner's (latent, comm_report(1), comm_report(2), comm_plan)
    of ``case`` on ``devices``."""
    latents, enc, mask = inputs
    fields, batch = _jax_fields(case)
    fields = {**fields, **extra}
    cfg = JaxDistriConfig(devices=devices, height=128, width=128, parallelism="pipefusion",
                          dtype=jnp.float32, batch_size=batch,
                          weight_quant=case.get("weight_quant", "none"), **fields)
    if cfg.weight_quant != "none":
        params = jax_quantize_params(params, cfg.weight_quant, compute=cfg.quant_compute)
    runner = JaxPipeFusionRunner(cfg, jax_dit.tiny_dit_config(depth=case["depth"]),
                                 params, jax_scheduler(case["scheduler"]))
    x = runner.generate(jnp.asarray(latents[:batch]), jnp.asarray(enc[:, :batch]),
                        guidance_scale=case["gs"], num_inference_steps=case["steps"],
                        cap_mask=jnp.asarray(mask[:, :batch]))
    stub = types.SimpleNamespace(distri_config=cfg, runner=runner)
    plan = jax_pipelines.DistriPixArtPipeline.comm_plan(stub, case["steps"])
    return np.asarray(x), runner.comm_report(1), runner.comm_report(2), plan


def expected_ticks(case, world, stage):
    """A rank's passes of each tick body: one mega-patch pass a synchronous
    step, one chunk pass an item (a deep stage's shallow ones pass
    through)."""
    dp = case.get("dp_degree", 1)
    split = (case.get("do_classifier_free_guidance", True)
             and case.get("split_batch", True))
    stages = world // dp // (2 if split else 1)
    patches = case.get("pipe_patches") or stages
    steps = case["steps"]
    n_sync = steps if case.get("mode") == "full_sync" else min(case["warmup_steps"] + 1,
                                                              steps)
    shallow = 0
    interval, depth = case.get("step_cache_interval", 1), case.get("step_cache_depth", 0)
    if interval > 1 and stage >= stages - depth:
        shallow = sum((s - n_sync) % interval < interval - 1
                      for s in range(n_sync, steps)) * patches
    items = (steps - n_sync) * patches
    return {"warmup": n_sync, "steady": items - shallow, "pass": shallow}


def run_world(world, cases, devices, tmp, params, refusals=(), patch_report=None):
    """``cases`` at ``world`` gloo ranks and on the JAX mesh of ``world``
    devices: (every rank's saved results, [JAX result] a case); the ranks
    also save the displaced patch runner's ``comm_report`` of the case
    ``patch_report`` where given."""
    jp, pp = params
    latents, enc, mask = _inputs()
    extra = {"params": {DEPTH: pp}, "latents": torch.from_numpy(latents),
             "enc": torch.from_numpy(enc), "mask": torch.from_numpy(mask),
             "patch_report": patch_report}
    torch.save({"cases": cases, "refusals": list(refusals), **extra}, tmp / "pf.pt")
    wait = run_ranks(world, pipefusion_worker, tmp, str(tmp / "pf.pt"), str(tmp / "out"),
                     join=False)
    want = [jax_run(devices[:world], case, jp, (latents, enc, mask)) for case in cases]
    wait()
    return [torch.load(f"{tmp / 'out'}.rank{r}") for r in range(world)], want


def check_cases(world, cases, port, want):
    for i, case in enumerate(cases):
        x, rep1, rep2, ticks, plan = port[0][i]
        for r in range(1, world):
            assert torch.equal(port[r][i][0], x), (case, r)
        want_x, want_rep1, want_rep2, want_plan = want[i]
        if case.get("comm_compress", "none") == "none":
            np.testing.assert_allclose(x.numpy(), want_x, rtol=TOL, atol=TOL,
                                       err_msg=str(case))
        else:  # a row may round to the next int8 step in one framework
            err = np.abs(x.numpy() - want_x).max() / np.abs(want_x).max()
            assert err <= COMPRESSED_TOL, (case, err)
        assert rep1 == want_rep1 and rep2 == want_rep2, (case, rep1, want_rep1)
        assert plan == want_plan, (case, plan, want_plan)
        for r in range(world):
            stage = r % (world // case.get("dp_degree", 1)) % rep1["stages"]
            assert port[r][i][3] == expected_ticks(case, world, stage), (case, r)


@pytest.fixture(scope="module")
def tiny_dit():
    return _seeded(port_dit.init_dit_params, port_dit.tiny_dit_config(depth=DEPTH), 20)


@pytest.fixture(scope="module")
def world4(devices8, tmp_path_factory, tiny_dit):
    refusals = [(dict(f), d) for f, d in REFUSALS]
    port, want = run_world(4, WORLD4, devices8, tmp_path_factory.mktemp("pf4"), tiny_dit,
                           refusals=refusals)
    # the hybrid case's JAX fused program too
    fused = jax_run(devices8[:4], {**WORLD4[-1], "hybrid_loop": False}, tiny_dit[0],
                    _inputs())
    return port, want, fused


@pytest.fixture(scope="module")
def world2(devices8, tmp_path_factory, tiny_dit):
    return run_world(2, WORLD2, devices8, tmp_path_factory.mktemp("pf2"), tiny_dit)


def test_world4_matches_jax(world4):
    port, want, _ = world4
    check_cases(4, WORLD4, port, want)


def test_world2_matches_jax(world2):
    port, want = world2
    check_cases(2, WORLD2, port, want)


def test_hybrid_loop_matches_fused(world4):
    """``hybrid_loop`` changes nothing in the port; its latent is the JAX
    runner's fused program's as well as its hybrid pair's."""
    port, _, fused = world4
    np.testing.assert_allclose(port[0][len(WORLD4) - 1][0].numpy(), fused[0],
                               rtol=TOL, atol=TOL)


def test_warmup_only_is_the_dense_loop(world4, tiny_dit):
    """Every step the mega-patch: the port's pipeline equals the port's
    dense DiT loop (``dit_forward`` a step) on the same weights."""
    port, _, _ = world4
    case = WORLD4[0]
    latents, enc, mask = (torch.from_numpy(a) for a in _inputs())
    sched = get_scheduler("ddim")
    sched.set_timesteps(case["steps"])
    dcfg = port_dit.tiny_dit_config(depth=DEPTH)
    x, state = latents[:1], sched.init_state(latents[:1].shape)
    for s in range(case["steps"]):
        eps = port_dit.dit_forward(tiny_dit[1], dcfg, x, sched.timesteps()[s], enc[0, :1],
                                   cap_mask=mask[0, :1])
        x, state = sched.step(x, eps, s, state)
    np.testing.assert_allclose(port[0][0][0].numpy(), x.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("i", range(len(REFUSALS)))
def test_refusals_match_jax(world4, devices8, i):
    """Each configuration is refused (with the JAX exception type) or
    accepted, at 4 ranks, as the JAX runner does at 4 devices."""
    port, _, _ = world4
    fields, dit_fields = REFUSALS[i]
    fields = dict(fields)
    h, w = fields.pop("height", 128), fields.pop("width", 128)
    dcfg = dataclasses.replace(jax_dit.tiny_dit_config(depth=DEPTH), **dit_fields)
    try:
        cfg = JaxDistriConfig(devices=devices8[:4], height=h, width=w,
                              parallelism="pipefusion", dtype=jnp.float32, **fields)
        JaxPipeFusionRunner(cfg, dcfg, {}, jax_scheduler("ddim"))
        jax_error = None
    except (ValueError, NotImplementedError) as e:
        jax_error = type(e).__name__
    for r in range(4):
        got = port[r]["refusal", i]
        assert (got and got[0]) == jax_error, (REFUSALS[i], got, jax_error)


def test_one_stage_matches_jax(devices8, tiny_dit):
    """One process, one stage, four chunks: the JAX runner's self-permuting
    ring; the per-step callback refused on both sides."""
    case = {**RUN, **NO_CFG, "warmup_steps": 1, "steps": 5, "pipe_patches": 4,
            "scheduler": "dpm-solver"}
    latents, enc, mask = _inputs()
    want = jax_run(devices8[:1], case, tiny_dit[0], (latents, enc, mask))
    fields, _ = _jax_fields(case)
    cfg = DistriConfig(device="cpu", height=128, width=128, parallelism="pipefusion",
                       **fields)
    runner = PipeFusionRunner(cfg, port_dit.tiny_dit_config(depth=DEPTH), tiny_dit[1],
                              get_scheduler("dpm-solver"))
    args = (torch.from_numpy(latents[:1]), torch.from_numpy(enc[:, :1]))
    x = runner.generate(*args, guidance_scale=1.0, num_inference_steps=5,
                        cap_mask=torch.from_numpy(mask[:, :1]))
    np.testing.assert_allclose(x.numpy(), want[0], rtol=TOL, atol=TOL)
    assert runner.comm_report(1) == want[1] and runner.comm_report(2) == want[2]
    assert runner.tick_counts == expected_ticks(case, 1, 0)
    with pytest.raises(ValueError, match="callbacks"):
        runner.generate(*args, num_inference_steps=2, callback=lambda *a: None)
    jcfg = JaxDistriConfig(devices=devices8[:1], height=128, width=128,
                           parallelism="pipefusion", dtype=jnp.float32, **fields)
    with pytest.raises(ValueError, match="callbacks"):
        JaxPipeFusionRunner(jcfg, jax_dit.tiny_dit_config(depth=DEPTH), tiny_dit[0],
                            jax_scheduler("ddim")).generate(
            jnp.asarray(latents[:1]), jnp.asarray(enc[:, :1]), num_inference_steps=2,
            callback=lambda *a: None)


@pytest.mark.parametrize("start", [0, 8, "device"])
def test_cache_commit_in_place_equals_the_copy(start):
    """``dit_block``'s cache mode commits the fresh rows into the cache it
    is given and attends over it: the block's output and KV are those of the
    copy-then-overwrite it replaced, and the cache afterwards is that copy,
    bit for bit (an int offset, or a device index as under graphs)."""
    dcfg = port_dit.tiny_dit_config(depth=1)
    bp = port_dit.init_dit_params(torch.Generator().manual_seed(3), dcfg)["blocks"][0]
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(2, 16, 64).astype(np.float32))
    c6 = torch.from_numpy(rs.randn(6, 64).astype(np.float32))
    cap_kv = torch.from_numpy(rs.randn(2, 7, 128).astype(np.float32))
    cache = torch.from_numpy(rs.randn(2, 64, 128).astype(np.float32))
    offset = 8 if start == "device" else start

    def copy_then_overwrite(kv):
        full = cache.clone()
        full[:, offset:offset + kv.shape[1]] = kv
        return full

    want, want_kv = port_dit.dit_block(bp, dcfg, x, c6, cap_kv,
                                       kv_assemble=copy_then_overwrite)
    committed = copy_then_overwrite(want_kv)
    patch_start = torch.tensor(offset) if start == "device" else start
    got, got_kv = port_dit.dit_block(bp, dcfg, x, c6, cap_kv, self_kv=cache,
                                     patch_start=patch_start)
    assert torch.equal(got, want) and torch.equal(got_kv, want_kv)
    assert torch.equal(cache, committed)


def test_pixart_pipeline_runs_pipefusion(tiny_dit):
    """``DistriPixArtPipeline(parallelism="pipefusion")`` at one process:
    its runner is PipeFusion's on the stage's blocks, its latent the
    runner's on the same inputs, ``set_stepwise`` refused, ``comm_plan``
    priced from ``comm_report``."""
    cfg = DistriConfig(device="cpu", height=128, width=128, parallelism="pipefusion",
                       pipe_patches=2, warmup_steps=1)
    dcfg = port_dit.tiny_dit_config(depth=DEPTH)
    vcfg = port_vae.tiny_vae_config()
    vae = port_vae.init_vae_params(torch.Generator().manual_seed(1), vcfg)
    pipe = DistriPixArtPipeline.from_params(cfg, dcfg, tiny_dit[1], vcfg, vae)
    assert isinstance(pipe.runner, PipeFusionRunner) and pipe.runner.patches == 2
    lat = torch.from_numpy(_inputs()[0][:1])
    out = pipe("a red boat", latents=lat, num_inference_steps=3, output_type="latent")
    emb, mask = pipe._encode(["a red boat"], [""])
    ref = PipeFusionRunner(cfg, dcfg, tiny_dit[1], get_scheduler("ddim")).generate(
        lat, emb, guidance_scale=4.5, num_inference_steps=3, cap_mask=mask)
    np.testing.assert_allclose(out.images[0], ref[0].numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="stepwise"):
        pipe.set_stepwise(True)
    plan = pipe.comm_plan(3)
    rep = pipe.runner.comm_report()
    assert plan["bytes_per_step"] == {"sync": rep["sync_step_collective_bytes"],
                                      "stale": rep["per_step_collective_bytes"]}
