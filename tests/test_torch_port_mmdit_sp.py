"""PyTorch port: the MMDiT's displaced patch parallelism
(parallel/mmdit_sp.py) against the JAX ``MMDiTDenoiseRunner`` at the same n.

The tiny MMDiT (``tiny_mmdit_config`` at depth 2, and SD3.5-medium's
layout: depth 3, q/k norms, two dual blocks), a 32x32 latent (256 tokens),
9 context tokens, runs 4 flow-euler steps on 2 and 4 gloo ranks (the
workers in tests/test_torch_port_ranks.py) and on the JAX package's fake
CPU mesh of as many devices, from the same seeded weights and inputs:

* world 2, sp 2 with the CFG branches folded: "gather" and "ring" with
  warmup 1 (2 synchronous, 2 stale steps), "gather" under ``full_sync``,
  and both layouts on the dual-block MMDiT (the dual attention's KV
  exchanged in buffers of its own);
* world 4, CFG 2 x sp 2 (split): "gather" and "ring" with warmup 1, both
  under ``no_sync`` (the warmup's buffers kept), and ``dp_degree=2`` (two
  image groups of sp 2, two images);

each latent within 5e-4 of the JAX one's largest value, the same on every
rank, its ``comm_report`` equal to the JAX one's key for key at batch 1 and
2, its phase counts and the callback's latent shapes as expected; each
world's first two cases also with ``use_cuda_graph=True`` (on the CPU the
static-buffer step without a capture), bit for bit with eager.  The
refusals (the JAX runner's ValueErrors) run in this process, and
``start_step`` against the steps it skips.  The comm knobs are held in
tests/test_torch_port_transformer_knobs.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.parallel.mmdit_sp import MMDiTDenoiseRunner as JaxMMDiTRunner
from distrifuser_tpu.schedulers import get_scheduler as jax_scheduler
from distrifuser_tpu_torch.models import mmdit as port_mm
from distrifuser_tpu_torch.parallel.mmdit_sp import MMDiTDenoiseRunner
from distrifuser_tpu_torch.schedulers import get_scheduler
from distrifuser_tpu_torch.utils.config import DistriConfig
from test_torch_port_ranks import mmdit_worker, run_ranks
from test_torch_port_sd3 import VARIANTS, seeded_mmdit

TOL = 5e-4
STEPS = 4
FOLDED = {"split_batch": False}
CASES = {
    2: [{"attn_impl": "gather", **FOLDED}, {"attn_impl": "ring", **FOLDED},
        {"mode": "full_sync", **FOLDED},
        {"attn_impl": "gather", "model": "dual", **FOLDED},
        {"attn_impl": "ring", "model": "dual", **FOLDED}],
    4: [{"attn_impl": "gather"}, {"attn_impl": "ring"},
        {"attn_impl": "gather", "mode": "no_sync"}, {"attn_impl": "ring", "mode": "no_sync"},
        {"dp_degree": 2, "batch_size": 2, **FOLDED}],
}


def _inputs():
    rs = np.random.RandomState(31)
    return (rs.randn(2, 32, 32, 4).astype(np.float32),
            rs.randn(2, 2, 9, 32).astype(np.float32), rs.randn(2, 2, 24).astype(np.float32))


@pytest.fixture(scope="module")
def models():
    """{name: (JAX config, JAX params, port config fields, port params)}."""
    out = {}
    for name, seed in (("plain", 40), ("dual", 41)):
        jcfg, jp, _, pp = seeded_mmdit(name, seed)
        out[name] = (jcfg, jp, {"depth": 2, **VARIANTS[name]}, pp)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, devices8, models, tmp_path_factory):
    n = request.param
    latents, enc, pooled = _inputs()
    tmp = tmp_path_factory.mktemp(f"mmdit{n}")
    torch.save({"cases": CASES[n], "base": {"warmup_steps": 1, "use_cuda_graph": False},
                "graphed": CASES[n][:2],
                "models": {k: (v[2], v[3]) for k, v in models.items()},
                "latents": torch.from_numpy(latents), "enc": torch.from_numpy(enc),
                "pooled": torch.from_numpy(pooled), "steps": STEPS}, tmp / "mmdit.pt")
    wait = run_ranks(n, mmdit_worker, tmp, str(tmp / "mmdit.pt"), str(tmp / "out"),
                     join=False)
    want = []
    for case in CASES[n]:  # the JAX runs while the ranks run
        case = dict(case)
        jcfg, jp, _, _ = models[case.pop("model", "plain")]
        batch = case.get("batch_size", 1)
        cfg = JaxDistriConfig(devices=devices8[:n], height=256, width=256, warmup_steps=1,
                              dtype=jnp.float32, **case)
        runner = JaxMMDiTRunner(cfg, jcfg, jp, jax_scheduler("flow-euler"))
        x = runner.generate(jnp.asarray(latents[:batch]), jnp.asarray(enc[:, :batch]),
                            jnp.asarray(pooled[:, :batch]), guidance_scale=7.0,
                            num_inference_steps=STEPS)
        want.append((np.asarray(x), runner.comm_report(1), runner.comm_report(2)))
    wait()
    port = [torch.load(f"{tmp / 'out'}.rank{r}") for r in range(n)]
    return n, port, want


def test_runner_matches_jax(world):
    n, port, want = world
    for i, case in enumerate(CASES[n]):
        x, rep1, rep2, phases, seen = port[0][i]
        for r in range(1, n):
            assert torch.equal(port[r][i][0], x), (case, r)
        want_x, want_rep1, want_rep2 = want[i]
        err = np.abs(x.numpy() - want_x).max() / np.abs(want_x).max()
        assert err <= TOL, (case, err)
        assert rep1 == want_rep1 and rep2 == want_rep2, case
        sync = STEPS if case.get("mode") == "full_sync" else 2
        assert phases == {"sync": sync, "stale": STEPS - sync}, case
        assert seen == [tuple(want_x.shape)] * STEPS, case


def test_graphed_runner_equals_eager(world):
    """``use_cuda_graph=True`` on the CPU (each phase's graph replayed
    without a capture) gives the eager latent bit for bit, in both
    layouts."""
    n, port, _ = world
    for i, case in enumerate(CASES[n][:2]):
        assert torch.equal(port[0]["graphed", i][0], port[0][i][0]), case


def test_stale_steps_move_the_latent(world):
    """The stale phase changes the result (it is not the synchronous run),
    and no_sync differs from the refreshing run."""
    n, port, _ = world
    if n == 2:
        gather, _, full = (port[0][i][0] for i in range(3))
        assert not torch.equal(gather, full)
    else:
        assert not torch.equal(port[0][0][0], port[0][2][0])
        assert not torch.equal(port[0][1][0], port[0][3][0])


def _cfg(**fields):
    return DistriConfig(device="cpu", **{"height": 256, "width": 256, **fields})


@pytest.mark.parametrize("fields,exc,match", [
    ({"comm_batch": True}, ValueError, "comm_batch"),
    ({"attn_impl": "ring", "comm_compress": "int8"}, ValueError, "comm_compress"),
    ({"attn_impl": "ring", "refresh_fraction": 0.5}, ValueError, "refresh_fraction"),
    ({"height": 512, "width": 512}, ValueError, "sample_size"),
    ({"parallelism": "tensor"}, ValueError, "parallelism"),
    ({"step_cache_interval": 2, "step_cache_depth": 2}, ValueError, "step_cache_depth"),
    ({"attn_impl": "ring", "comm_compress": "fp8"}, ValueError, "comm_compress"),
    ({"refresh_fraction": 1 / 3}, ValueError, "divisible by 3"),
    ({"step_cache_interval": 2, "step_cache_depth": 3}, ValueError, "step_cache_depth"),
])
def test_runner_refusals(fields, exc, match):
    mcfg = dataclasses.replace(port_mm.tiny_mmdit_config(), depth=2)
    with pytest.raises(exc, match=match):
        MMDiTDenoiseRunner(_cfg(**fields), mcfg, {}, get_scheduler("flow-euler"))


@pytest.mark.parametrize("attn_impl", ["ulysses", "usp"])
def test_head_sharded_layouts_refused(devices8, attn_impl):
    """ulysses and usp: ``DistriConfig`` accepts them (the DiT runs them);
    the MMDiT runner refuses them as undefined for joint attention with
    the JAX runner's ValueError."""
    cfg = _cfg(attn_impl=attn_impl)
    mcfg = port_mm.tiny_mmdit_config()
    with pytest.raises(ValueError, match="joint"):
        MMDiTDenoiseRunner(cfg, mcfg, {}, get_scheduler("flow-euler"))
    jcfg = JaxDistriConfig(devices=devices8[:2], height=256, width=256,
                           attn_impl=attn_impl)
    from distrifuser_tpu.models import mmdit as jax_mm

    with pytest.raises(ValueError, match="joint"):
        JaxMMDiTRunner(jcfg, jax_mm.tiny_mmdit_config(), {}, jax_scheduler("flow-euler"))


def test_jax_runner_refuses_the_same(devices8):
    """The ValueErrors above are the JAX runner's own."""
    from distrifuser_tpu.models import mmdit as jax_mm

    mcfg = dataclasses.replace(jax_mm.tiny_mmdit_config(), depth=2)
    for fields in ({"comm_batch": True}, {"attn_impl": "ring", "comm_compress": "int8"},
                   {"attn_impl": "ring", "refresh_fraction": 0.5},
                   {"height": 512, "width": 512},
                   {"step_cache_interval": 2, "step_cache_depth": 2}):
        cfg = JaxDistriConfig(devices=devices8[:2], **{"height": 256, "width": 256,
                                                        **fields})
        with pytest.raises(ValueError):
            JaxMMDiTRunner(cfg, mcfg, {}, jax_scheduler("flow-euler"))


def test_dense_runner_steps(models):
    """One device, CFG folded: the runner's first step is the dense
    forward's guided velocity through the flow scheduler; ``start_step``
    runs only the steps from it (img2img's entry), ``end_step`` stops
    early, and the graphed CPU loop equals the eager one."""
    _, _, fields, params = models["plain"]
    mcfg = dataclasses.replace(port_mm.tiny_mmdit_config(), **fields)
    latents, enc, pooled = (torch.from_numpy(a) for a in _inputs())
    sched = get_scheduler("flow-euler")
    runner = MMDiTDenoiseRunner(_cfg(use_cuda_graph=False), mcfg, params, sched)
    got = runner.generate(latents[:1], enc[:, :1], pooled[:, :1], guidance_scale=7.0,
                          num_inference_steps=1)
    sched.set_timesteps(1)
    v = port_mm.mmdit_forward(params, mcfg, torch.cat([latents[:1]] * 2),
                              sched.timesteps()[0], enc[:, :1].reshape(2, 9, 32),
                              pooled[:, :1].reshape(2, 24))
    guided = v[:1] + 7.0 * (v[1:] - v[:1])
    want, _ = sched.step(latents[:1], guided, 0, {})
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    seen = []
    kw = dict(guidance_scale=7.0, num_inference_steps=4, start_step=2,
              callback=lambda i, t, x: seen.append(i))
    tail = runner.generate(latents[:1], enc[:, :1], pooled[:, :1], **kw)
    assert seen == [2, 3] and runner.phase_counts == {"sync": 2, "stale": 0}
    graphed = MMDiTDenoiseRunner(_cfg(), mcfg, params, get_scheduler("flow-euler"))
    assert torch.equal(graphed.generate(latents[:1], enc[:, :1], pooled[:, :1], **kw), tail)
    seen.clear()
    runner.generate(latents[:1], enc[:, :1], pooled[:, :1], guidance_scale=7.0,
                    num_inference_steps=4, end_step=3, callback=lambda i, t, x: seen.append(i))
    assert seen == [0, 1, 2]
