"""PyTorch port: the displaced patch runner at world 2 against the JAX package.

Tiny SDXL (the full SDXL block structure at narrow widths), 128 x 128, on
two gloo ranks without the CFG split (sp 2, ``split_batch=False``) against
the JAX ``DenoiseRunner`` on a fake CPU mesh of the same two devices, in
each of the six sync modes: ``warmup_steps=1`` and 4 DDIM steps, so steps
0-1 are synchronous and steps 2-3 stale (``full_sync``: all four
synchronous).  Same weights (JAX-initialised, carried across by
``params_from_jax``) and the same numpy latents and embeddings, float32.
The latents agree within 5e-4 of their largest magnitude, are the same on
both ranks, and ``comm_volume_report`` equals the JAX package's exactly.
World 4 (CFG 2 x sp 2 and sp 4) and the pipeline are in
tests/test_torch_port_patch_world4.py.
"""

import jax
import numpy as np
import pytest
import torch

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.models import unet as jax_unet
from distrifuser_tpu.parallel.runner import make_runner as make_jax_runner
from distrifuser_tpu.schedulers import get_scheduler
from distrifuser_tpu.utils.config import SYNC_MODES
from distrifuser_tpu_torch.models.weights import params_from_jax
from test_torch_port_ranks import run_ranks, runner_worker

REL = 5e-4
STEPS = 4


def runner_inputs():
    """(JAX UNet params, latents, branch-major embeddings, added cond)."""
    ucfg = jax_unet.tiny_config(cross_attention_dim=32, sdxl=True)
    params = jax_unet.init_unet_params(jax.random.PRNGKey(0), ucfg)
    rs = np.random.RandomState(3)
    latents = rs.randn(1, 16, 16, 4).astype(np.float32)
    enc = rs.randn(2, 1, 7, 32).astype(np.float32)
    added = {"text_embeds": rs.randn(2, 1, 32).astype(np.float32),
             "time_ids": np.tile(np.float32([128, 128, 0, 0, 128, 128]), (2, 1, 1))}
    return ucfg, params, latents, enc, added


def run_both(devices, tmp, world, cases):
    """{case: (port latents per rank, port comm volume, port phase counts,
    JAX latents, JAX comm volume)} for ``cases`` (config-field dicts)."""
    ucfg, params, latents, enc, added = runner_inputs()
    torch.save({"cases": cases, "params": params_from_jax(jax.device_get(params)),
                "latents": torch.from_numpy(latents), "enc": torch.from_numpy(enc),
                "added": {k: torch.from_numpy(v) for k, v in added.items()}},
               tmp / f"runner{world}.pt")
    out = tmp / f"runner_out{world}"
    run_ranks(world, runner_worker, tmp, str(tmp / f"runner{world}.pt"), str(out))
    ranks = [torch.load(f"{out}.rank{r}") for r in range(world)]
    results, jax_runs = {}, {}
    for case in cases:
        key = tuple(sorted(case.items()))
        # the JAX package runs its compiled loop whatever the port's
        # use_cuda_graph: one JAX run serves the port's eager and graphed cases
        jkey = tuple(kv for kv in key if kv[0] != "use_cuda_graph")
        if jkey not in jax_runs:
            jcfg = JaxDistriConfig(devices=devices[:world], height=128, width=128,
                                   warmup_steps=1, **dict(jkey))
            jrunner = make_jax_runner(jcfg, ucfg, params, get_scheduler("ddim"))
            want = np.asarray(jrunner.generate(latents, enc, added_cond=added,
                                               num_inference_steps=STEPS,
                                               guidance_scale=5.0))
            jax_runs[jkey] = (want, jrunner.comm_volume_report())
        port = [r[key] for r in ranks]
        results[key] = ([p[0].numpy() for p in port], port[0][1], port[0][2],
                        *jax_runs[jkey])
    return results


def check_case(result, mode):
    port_x, port_comm, phases, want, want_comm = result
    assert np.isfinite(want).all()
    for x in port_x:  # every rank holds the same latent
        np.testing.assert_array_equal(x, port_x[0])
    err = np.abs(port_x[0] - want).max() / np.abs(want).max()
    assert err <= REL, err
    assert port_comm == want_comm
    stale = 0 if mode == "full_sync" else STEPS - 2
    assert phases == {"sync": STEPS - stale, "stale": stale}


@pytest.fixture(scope="module")
def world2(devices8, tmp_path_factory):
    cases = [{"mode": m, "split_batch": False} for m in SYNC_MODES]
    return run_both(devices8, tmp_path_factory.mktemp("runner2"), 2, cases)


@pytest.mark.parametrize("mode", SYNC_MODES)
def test_runner_world2_sp2_matches_jax(world2, mode):
    check_case(world2[(("mode", mode), ("split_batch", False))], mode)
