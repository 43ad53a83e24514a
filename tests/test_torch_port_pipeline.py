"""PyTorch port: the tiny SDXL pipeline against the JAX one at one device.

Both pipelines get the same JAX-initialised weights (the port's through
``params_from_jax``), the same prompt and the same numpy initial latents,
and run 3 DDIM steps to ``output_type="latent"`` in float32 on the CPU.
Tolerance: 2e-4 absolute on latents that reach |13| with random weights;
the measured max |delta| was 3.2e-5 (float32 sum-order differences through
three UNet evaluations).  The decoded image path is held to the same bound.
"""

import jax
import numpy as np
import pytest

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.models import clip as jax_clip
from distrifuser_tpu.models import unet as jax_unet
from distrifuser_tpu.models import vae as jax_vae
from distrifuser_tpu.pipelines import DistriSDXLPipeline as JaxSDXLPipeline
from distrifuser_tpu_torch import DistriConfig, DistriSDXLPipeline
from distrifuser_tpu_torch.models import clip as port_clip
from distrifuser_tpu_torch.models import unet as port_unet
from distrifuser_tpu_torch.models import vae as port_vae
from distrifuser_tpu_torch.models.weights import params_from_jax

TOL = 2e-4
PROMPT = "a lighthouse at dusk"


def _text_configs(mod):
    """SDXL-shaped tiny encoders: hidden widths 16 + 16 concatenate to the
    UNet's cross_attention_dim 32; encoder 2 projects pooled embeds to 32."""
    return [
        mod.tiny_clip_config(hidden=16),
        mod.CLIPTextConfig(vocab_size=1000, hidden_size=16, num_hidden_layers=2,
                           num_attention_heads=4, intermediate_size=32,
                           projection_dim=32),
    ]


@pytest.fixture(scope="module")
def pipelines(devices8):
    jcfg = JaxDistriConfig(devices=devices8[:1], height=128, width=128,
                           warmup_steps=1)
    ucfg = jax_unet.tiny_config(cross_attention_dim=32, sdxl=True)
    vcfg = jax_vae.tiny_vae_config()
    tcfgs = _text_configs(jax_clip)
    unet_p = jax_unet.init_unet_params(jax.random.PRNGKey(0), ucfg)
    vae_p = jax_vae.init_vae_params(jax.random.PRNGKey(1), vcfg)
    text_p = [jax_clip.init_clip_params(jax.random.PRNGKey(2 + i), tc)
              for i, tc in enumerate(tcfgs)]
    jpipe = JaxSDXLPipeline.from_params(jcfg, ucfg, unet_p, vcfg, vae_p, tcfgs, text_p)

    pcfg = DistriConfig(device="cpu", height=128, width=128, warmup_steps=1)
    ppipe = DistriSDXLPipeline.from_params(
        pcfg, port_unet.tiny_config(cross_attention_dim=32, sdxl=True),
        params_from_jax(jax.device_get(unet_p)), port_vae.tiny_vae_config(),
        params_from_jax(jax.device_get(vae_p)), _text_configs(port_clip),
        [params_from_jax(jax.device_get(p)) for p in text_p],
    )
    return jpipe, ppipe


def _latents(seed=5):
    return np.random.RandomState(seed).randn(1, 16, 16, 4).astype(np.float32)


def test_sdxl_latents_match_jax(pipelines):
    jpipe, ppipe = pipelines
    kw = dict(num_inference_steps=3, guidance_scale=5.0, output_type="latent")
    want = jpipe(PROMPT, latents=_latents(), **kw).images[0]
    got = ppipe(PROMPT, latents=_latents(), **kw).images[0]
    assert got.shape == want.shape == (16, 16, 4)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


def test_sdxl_images_match_jax(pipelines):
    jpipe, ppipe = pipelines
    kw = dict(num_inference_steps=2, output_type="np")
    want = jpipe(PROMPT, latents=_latents(6), **kw).images[0]
    got = ppipe(PROMPT, latents=_latents(6), **kw).images[0]
    assert got.shape == want.shape == (32, 32, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


def test_seeded_noise_is_deterministic(pipelines):
    _, ppipe = pipelines
    kw = dict(num_inference_steps=2, output_type="latent")
    a = ppipe("a corgi", seed=1, **kw).images[0]
    b = ppipe("a corgi", seed=1, **kw).images[0]
    c = ppipe("a corgi", seed=2, **kw).images[0]
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0
    img = ppipe("a corgi", seed=1, num_inference_steps=1).images[0]
    assert img.size == (32, 32)
