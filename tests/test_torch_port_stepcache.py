"""PyTorch port: the temporal step cache against the JAX package.

* the cadence functions of parallel/stepcache.py equal the JAX package's
  over a grid of step counts, warmups and intervals, and ``DistriConfig``
  refuses exactly the knob combinations the JAX one refuses (the comm knobs
  and the step cache over a grid);
* ``unet_forward`` with ``cache_depth`` 1 on the tiny SDXL and SD UNets,
  full (``(out, deep)``) and shallow (resuming from the deep feature),
  within 5e-4 of the JAX forward on the same tree and inputs;
* the one-rank runner under the cadence (interval 2 and 3, warmup 1, 6
  DDIM steps) against the JAX run within 2e-4, with the phase counts, the
  evaluations it lists, ``step_cache_plan`` and the per-phase report;
* the step cache on the CPU static-buffer graph path equals the eager run
  bit for bit.
"""

import dataclasses
import itertools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.models import unet as jax_unet
from distrifuser_tpu.parallel import stepcache as jax_stepcache
from distrifuser_tpu.parallel.runner import make_runner as make_jax_runner
from distrifuser_tpu.pipelines import DistriSDXLPipeline as JaxSDXLPipeline
from distrifuser_tpu.schedulers import get_scheduler
from distrifuser_tpu_torch.models import unet as port_unet
from distrifuser_tpu_torch.models.weights import params_from_jax
from distrifuser_tpu_torch.parallel import stepcache as port_stepcache
from distrifuser_tpu_torch.parallel.runner import make_runner
from distrifuser_tpu_torch.pipelines import DistriSDXLPipeline
from distrifuser_tpu_torch.schedulers import get_scheduler as port_scheduler
from distrifuser_tpu_torch.utils.config import DistriConfig

UNET_TOL = 5e-4
RUN_TOL = 2e-4


def test_cadence_functions_match_jax():
    for rest, interval in itertools.product(range(0, 13), range(2, 5)):
        assert (port_stepcache.cadence_split(rest, interval)
                == jax_stepcache.cadence_split(rest, interval))
    for k, interval in itertools.product(range(12), range(2, 5)):
        assert (port_stepcache.is_shallow_step(k, interval)
                == jax_stepcache.is_shallow_step(k, interval))
    for i, start, interval in itertools.product(range(12), range(4), range(1, 5)):
        assert (port_stepcache.is_shallow_at(i, start, interval)
                == jax_stepcache.is_shallow_at(i, start, interval))
    for steps, warmup, interval in itertools.product(range(0, 12), range(0, 5),
                                                     range(1, 5)):
        assert (port_stepcache.phase_step_counts(steps, warmup, interval)
                == jax_stepcache.phase_step_counts(steps, warmup, interval))
        assert (port_stepcache.shallow_step_count(steps, warmup, interval)
                == jax_stepcache.shallow_step_count(steps, warmup, interval))
    with pytest.raises(ValueError, match="interval"):
        port_stepcache.cadence_split(4, 1)
    assert port_stepcache.STEPCACHE_KEY == jax_stepcache.STEPCACHE_KEY


# every combination of the knobs' values that changes what is refused;
# (ulysses and usp, which both configs accept at one device, below)
CONFIG_GRID = {
    "parallelism": ["patch", "naive_patch", "tensor"],
    "comm_compress": ["none", "int8", "int8_residual", "int4"],
    "refresh_fraction": [1.0, 0.5, 0.3],
    "comm_batch": [False, True],
    "step_cache": [(1, 0), (2, 1), (2, 0), (1, 1), (0, 0)],
    "attn_impl": ["gather", "ring"],
}


def _outcome(make):
    try:
        make()
        return "ok"
    except ValueError:
        return "ValueError"


def test_config_refusals_match_jax(devices8):
    keys = list(CONFIG_GRID)
    seen = set()
    for values in itertools.product(*CONFIG_GRID.values()):
        fields = dict(zip(keys, values))
        interval, depth = fields.pop("step_cache")
        fields.update(step_cache_interval=interval, step_cache_depth=depth,
                      height=128, width=128)
        want = _outcome(lambda: JaxDistriConfig(devices=devices8[:1], **fields))
        got = _outcome(lambda: DistriConfig(device="cpu", **fields))
        assert got == want, fields
        seen.add(want)
    assert seen == {"ok", "ValueError"}
    for impl in ("ulysses", "usp"):
        fields = {"attn_impl": impl, "height": 128, "width": 128}
        assert _outcome(lambda: DistriConfig(device="cpu", **fields)) == _outcome(
            lambda: JaxDistriConfig(devices=devices8[:1], **fields)) == "ok"


def _unet_inputs(sdxl):
    r = np.random.RandomState(1)
    sample = r.randn(2, 16, 16, 4).astype(np.float32)
    enc = r.randn(2, 8, 32).astype(np.float32)
    t = np.array([981, 501], np.int64)
    added = None
    if sdxl:
        added = {"text_embeds": r.randn(2, 32).astype(np.float32),
                 "time_ids": np.tile(np.array([128, 128, 0, 0, 128, 128],
                                              np.float32), (2, 1))}
    return sample, t, enc, added


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


@pytest.mark.parametrize("sdxl", [True, False], ids=["sdxl", "sd"])
def test_unet_forward_full_and_shallow_match_jax(sdxl):
    jcfg = jax_unet.tiny_config(cross_attention_dim=32, sdxl=sdxl)
    jparams = jax_unet.init_unet_params(jax.random.PRNGKey(0), jcfg)
    sample, t, enc, added = _unet_inputs(sdxl)
    jadded = None if added is None else jax.tree.map(jnp.asarray, added)
    full = jax.jit(lambda p, x, deep: jax_unet.unet_forward(
        p, jcfg, x, jnp.asarray(t), jnp.asarray(enc), added_cond=jadded,
        cache_depth=1, deep_cache=deep))
    want_out, want_deep = full(jparams, jnp.asarray(sample), None)
    sample2 = sample[::-1].copy()
    want_shallow, none = full(jparams, jnp.asarray(sample2), want_deep)
    assert none is None

    pcfg = port_unet.tiny_config(cross_attention_dim=32, sdxl=sdxl)
    pparams = params_from_jax(jax.device_get(jparams))
    padded = None if added is None else {k: torch.from_numpy(v) for k, v in added.items()}
    out, deep = port_unet.unet_forward(
        pparams, pcfg, torch.from_numpy(sample), torch.from_numpy(t),
        torch.from_numpy(enc), added_cond=padded, cache_depth=1)
    assert tuple(deep.shape) == want_deep.shape
    assert _rel(out, want_out) <= UNET_TOL
    assert _rel(deep, want_deep) <= UNET_TOL
    # the shallow step resumes from the JAX deep feature: only its own
    # layers' differences remain
    shallow, none = port_unet.unet_forward(
        pparams, pcfg, torch.from_numpy(sample2), torch.from_numpy(t),
        torch.from_numpy(enc), added_cond=padded, cache_depth=1,
        deep_cache=torch.from_numpy(np.array(want_deep)))
    assert none is None
    assert _rel(shallow, want_shallow) <= UNET_TOL
    # the full forward without the cache is the same function
    plain = port_unet.unet_forward(pparams, pcfg, torch.from_numpy(sample),
                                   torch.from_numpy(t), torch.from_numpy(enc),
                                   added_cond=padded)
    assert torch.equal(plain, out)
    with pytest.raises(ValueError, match="cache_depth"):
        port_unet.unet_forward(pparams, pcfg, torch.from_numpy(sample),
                               torch.from_numpy(t), torch.from_numpy(enc),
                               added_cond=padded, cache_depth=2)


def _runner_inputs():
    ucfg = jax_unet.tiny_config(cross_attention_dim=32, sdxl=True)
    params = jax_unet.init_unet_params(jax.random.PRNGKey(0), ucfg)
    rs = np.random.RandomState(3)
    latents = rs.randn(1, 16, 16, 4).astype(np.float32)
    enc = rs.randn(2, 1, 7, 32).astype(np.float32)
    added = {"text_embeds": rs.randn(2, 1, 32).astype(np.float32),
             "time_ids": np.tile(np.float32([128, 128, 0, 0, 128, 128]), (2, 1, 1))}
    return ucfg, params, latents, enc, added


@pytest.mark.parametrize("interval, phases", [
    (2, ["sync", "sync", "shallow", "sync", "shallow", "sync"]),
    (3, ["sync", "sync", "shallow", "shallow", "sync", "shallow"]),
])
def test_one_rank_cadence_matches_jax(devices8, interval, phases):
    ucfg, params, latents, enc, added = _runner_inputs()
    fields = dict(height=128, width=128, warmup_steps=1, step_cache_interval=interval,
                  step_cache_depth=1)
    jcfg = JaxDistriConfig(devices=devices8[:1], **fields)
    jrunner = make_jax_runner(jcfg, ucfg, params, get_scheduler("ddim"))
    want = np.asarray(jrunner.generate(latents, enc, added_cond=added,
                                       num_inference_steps=6, guidance_scale=5.0))
    jrunner._flop_estimate = lambda *a, **k: None
    want_rep = jrunner.comm_volume_report(per_phase=True)

    runs = {}
    for graphed in (False, True):
        cfg = DistriConfig(device="cpu", use_cuda_graph=graphed, **fields)
        runner = make_runner(cfg, ucfg, params_from_jax(jax.device_get(params)),
                             port_scheduler("ddim"))
        assert runner._phases(6) == phases
        runs[graphed] = runner.generate(
            torch.from_numpy(latents), torch.from_numpy(enc),
            added_cond={k: torch.from_numpy(v) for k, v in added.items()},
            num_inference_steps=6, guidance_scale=5.0)
        assert runner.phase_counts == {"sync": phases.count("sync"), "stale": 0,
                                       "shallow": phases.count("shallow")}
        rep = runner.comm_volume_report(per_phase=True)
        assert rep["phases"] == want_rep["phases"]
        assert rep["bytes"] == want_rep["bytes"]
    assert torch.equal(runs[True], runs[False])
    assert _rel(runs[False], want) <= RUN_TOL
    plan = DistriSDXLPipeline.step_cache_plan(SimpleNamespace(distri_config=cfg), 6)
    assert plan == JaxSDXLPipeline.step_cache_plan(SimpleNamespace(distri_config=jcfg), 6)
    assert plan["shallow_steps"] == phases.count("shallow")


def test_step_cache_plan_matches_jax(devices8):
    for steps, warmup, interval, depth in itertools.product(
            (1, 4, 9), (0, 2), (1, 2, 3), (0, 1)):
        if (interval > 1) != (depth > 0):
            continue
        fields = dict(height=128, width=128, warmup_steps=warmup,
                      step_cache_interval=interval, step_cache_depth=depth)
        got = DistriSDXLPipeline.step_cache_plan(
            SimpleNamespace(distri_config=DistriConfig(device="cpu", **fields)), steps)
        want = JaxSDXLPipeline.step_cache_plan(SimpleNamespace(
            distri_config=JaxDistriConfig(devices=devices8[:1], **fields)), steps)
        assert got == want


def test_runner_refuses_a_cache_as_deep_as_the_unet():
    ucfg = port_unet.tiny_config(cross_attention_dim=32, sdxl=True)
    params = port_unet.init_unet_params(torch.Generator().manual_seed(0), ucfg)
    cfg = DistriConfig(device="cpu", height=128, width=128, step_cache_interval=2,
                       step_cache_depth=2)
    with pytest.raises(ValueError, match="step_cache_depth"):
        make_runner(cfg, ucfg, params, port_scheduler("ddim"))
    assert dataclasses.replace(cfg, step_cache_depth=1).step_cache_enabled
