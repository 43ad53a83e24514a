"""PyTorch port: the tiny SD pipeline at two gloo ranks against the JAX package.

DistriFusion's ``stale_gn`` mode, the mode of the reference's SD example,
with ``warmup_steps=1`` and 3 DPM++ 2M steps (2 synchronous, 1 stale):
without the CFG split (sp 2, both branches on each rank's half of the
rows), in eager and static-buffer steps, and with it (CFG 2 x sp 1, one
branch a rank).  The JAX ``DistriSDPipeline`` runs on a fake CPU mesh of
the same two devices with the same weights, prompt and latents.  Every
rank returns the same latent, within 5e-4 of the JAX one relative to its
largest magnitude (the n-rank tolerance), and the static-buffer step
equals the eager one bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.pipelines import DistriSDPipeline as JaxSDPipeline
from distrifuser_tpu_torch.models.weights import params_from_jax
from test_torch_port_ranks import run_ranks, sd_pipeline_worker
from test_torch_port_sd_pipeline import jax_trees

REL = 5e-4
WORLD = 2
PROMPT = "a lighthouse at dusk"
SCHEDULER = "dpm-solver"
CASES = [{"mode": "stale_gn", "warmup_steps": 1, "split_batch": s, "use_cuda_graph": g}
         for s, g in ((False, False), (False, True), (True, False))]


def _key(case):
    return tuple(sorted(case.items()))


@pytest.fixture(scope="module")
def runs(devices8, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sd_patch")
    ucfg, vcfg, tcfg, unet_p, vae_p, text_p = jax_trees()
    latents = np.random.RandomState(5).randn(1, 16, 16, 4).astype(np.float32)
    conv = lambda t: params_from_jax(jax.device_get(t))  # noqa: E731
    torch.save({"cases": CASES, "unet_config": dataclasses.asdict(ucfg),
                "vae_config": dataclasses.asdict(vcfg),
                "text_config": dataclasses.asdict(tcfg), "unet": conv(unet_p),
                "vae": conv(vae_p), "text": conv(text_p), "prompt": PROMPT,
                "scheduler": SCHEDULER, "latents": torch.from_numpy(latents)},
               tmp / "sd.pt")
    run_ranks(WORLD, sd_pipeline_worker, tmp, str(tmp / "sd.pt"), str(tmp / "out"))
    port = [torch.load(f"{tmp / 'out'}.rank{r}", weights_only=False) for r in range(WORLD)]
    want = {}
    for split in (False, True):
        jcfg = JaxDistriConfig(devices=devices8[:WORLD], height=128, width=128,
                               warmup_steps=1, mode="stale_gn", split_batch=split)
        jpipe = JaxSDPipeline.from_params(jcfg, ucfg, unet_p, vcfg, vae_p, [tcfg],
                                          [text_p], scheduler=SCHEDULER)
        want[split] = np.asarray(jpipe(PROMPT, latents=latents, num_inference_steps=3,
                                       output_type="latent").images[0])
    return port, want


@pytest.mark.parametrize("case", CASES, ids=lambda c: (
    ("cfg2_sp1" if c["split_batch"] else "sp2")
    + ("_graphed" if c["use_cuda_graph"] else "_eager")))
def test_sd_stale_gn_world2_matches_jax(runs, case):
    port, want = runs
    latents = [r[_key(case)][0] for r in port]
    for x in latents:
        np.testing.assert_array_equal(x, latents[0])
    ref = want[case["split_batch"]]
    assert latents[0].shape == ref.shape == (16, 16, 4) and np.isfinite(ref).all()
    np.testing.assert_allclose(latents[0], ref, rtol=0, atol=REL * np.abs(ref).max())
    phases = port[0][_key(case)][1]
    if case["split_batch"]:  # one patch a branch: every step synchronous
        assert phases == {"sync": 3, "stale": 0}
    else:
        assert phases == {"sync": 2, "stale": 1}


def test_sd_stale_gn_world2_graphed_equals_eager(runs):
    port, _ = runs
    for r in port:
        np.testing.assert_array_equal(r[_key(CASES[0])][0], r[_key(CASES[1])][0])
