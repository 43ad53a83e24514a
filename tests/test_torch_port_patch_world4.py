"""PyTorch port: the displaced patch path at world 4 against the JAX package.

The runner on tiny SDXL at CFG 2 x sp 2 (``split_batch=True``) and at sp 4
(``split_batch=False``), in ``full_sync`` and ``corrected_async_gn``,
against the JAX ``DenoiseRunner`` on a fake CPU mesh of the same four
devices (see tests/test_torch_port_patch_runner.py for the setting and the
bounds); and the tiny SDXL pipeline at world 4 (CFG 2 x sp 2,
``warmup_steps=1``) against the JAX ``DistriSDXLPipeline`` at the same n:
latents after 3 steps within 2e-4, the bound of the single-device pipeline
test, the image after 2 steps within the same, the same on every rank, and
the step callback fired once per step with two stale steps.
"""

import jax
import numpy as np
import pytest
import torch

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.models import clip as jax_clip
from distrifuser_tpu.models import unet as jax_unet
from distrifuser_tpu.models import vae as jax_vae
from distrifuser_tpu.pipelines import DistriSDXLPipeline as JaxSDXLPipeline
from distrifuser_tpu_torch.models.weights import params_from_jax
from test_torch_port_patch_runner import check_case, run_both
from test_torch_port_ranks import pipeline_worker, run_ranks

PIPE_TOL = 2e-4
PROMPT = "a lighthouse at dusk"
CASES = [{"mode": m, "split_batch": s}
         for s in (True, False) for m in ("full_sync", "corrected_async_gn")]


@pytest.fixture(scope="module")
def world4(devices8, tmp_path_factory):
    return run_both(devices8, tmp_path_factory.mktemp("runner4"), 4, CASES)


@pytest.mark.parametrize("case", CASES, ids=lambda c: ("cfg2_sp2" if c["split_batch"]
                                                       else "sp4") + "_" + c["mode"])
def test_runner_world4_matches_jax(world4, case):
    check_case(world4[tuple(sorted(case.items()))], case["mode"])


@pytest.fixture(scope="module")
def pipelines(devices8, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline4")
    ucfg = jax_unet.tiny_config(cross_attention_dim=32, sdxl=True)
    vcfg = jax_vae.tiny_vae_config()
    tcfgs = [jax_clip.tiny_clip_config(hidden=16),
             jax_clip.CLIPTextConfig(vocab_size=1000, hidden_size=16,
                                     num_hidden_layers=2, num_attention_heads=4,
                                     intermediate_size=32, projection_dim=32)]
    unet_p = jax_unet.init_unet_params(jax.random.PRNGKey(0), ucfg)
    vae_p = jax_vae.init_vae_params(jax.random.PRNGKey(1), vcfg)
    text_p = [jax_clip.init_clip_params(jax.random.PRNGKey(2 + i), tc)
              for i, tc in enumerate(tcfgs)]
    latents = np.random.RandomState(5).randn(1, 16, 16, 4).astype(np.float32)
    jcfg = JaxDistriConfig(devices=devices8[:4], height=128, width=128, warmup_steps=1)
    jpipe = JaxSDXLPipeline.from_params(jcfg, ucfg, unet_p, vcfg, vae_p, tcfgs, text_p)
    want_latent = np.asarray(jpipe(PROMPT, latents=latents, num_inference_steps=3,
                                   output_type="latent").images[0])
    want_image = np.asarray(jpipe(PROMPT, latents=latents, num_inference_steps=2,
                                  output_type="np").images[0])
    conv = lambda t: params_from_jax(jax.device_get(t))  # noqa: E731
    torch.save({"unet": conv(unet_p), "vae": conv(vae_p),
                "text": [conv(p) for p in text_p], "prompt": PROMPT,
                "latents": torch.from_numpy(latents)}, tmp / "pipeline.pt")
    run_ranks(4, pipeline_worker, tmp, str(tmp / "pipeline.pt"), str(tmp / "out"))
    port = [torch.load(f"{tmp / 'out'}.rank{r}", weights_only=False) for r in range(4)]
    return port, want_latent, want_image


def test_pipeline_world4_matches_jax(pipelines):
    port, want_latent, want_image = pipelines
    for r in port:
        np.testing.assert_array_equal(r["latent"], port[0]["latent"])
        np.testing.assert_array_equal(r["image"], port[0]["image"])
    got = port[0]["latent"]
    assert got.shape == want_latent.shape == (16, 16, 4)
    np.testing.assert_allclose(got, want_latent, rtol=0, atol=PIPE_TOL)
    assert port[0]["image"].shape == want_image.shape == (32, 32, 3)
    np.testing.assert_allclose(port[0]["image"], want_image, rtol=0, atol=PIPE_TOL)


def test_pipeline_world4_runs_stale_steps_and_callback(pipelines):
    port, _, _ = pipelines
    for r in port:
        assert r["steps"] == [0, 1, 2]
        assert r["phase_counts"] == {"sync": 2, "stale": 1}
