"""PyTorch port: the tiny SD pipeline against the JAX one at one device.

``DistriSDPipeline`` with an SD-shaped tiny UNet (four levels, SD 1.5's
conv projections), the tiny VAE and one tiny CLIP text encoder whose final
hidden state conditions the UNet; both pipelines get the same
JAX-initialised weights (the port's through ``params_from_jax``), the same
prompt and the same numpy initial latents, and run 3 steps of DDIM, Euler
or DPM++ 2M to ``output_type="latent"`` in float32 on the CPU.  Latents
agree within 2e-4, the pipeline tolerance of the SDXL test, and the port's
static-buffer step (``use_cuda_graph=True``, on the CPU without a capture)
equals its eager step bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.models import clip as jax_clip
from distrifuser_tpu.models import unet as jax_unet
from distrifuser_tpu.models import vae as jax_vae
from distrifuser_tpu.pipelines import DistriSDPipeline as JaxSDPipeline
from distrifuser_tpu_torch import DistriConfig, DistriSDPipeline
from distrifuser_tpu_torch.models import clip as port_clip
from distrifuser_tpu_torch.models import unet as port_unet
from distrifuser_tpu_torch.models import vae as port_vae
from distrifuser_tpu_torch.models.weights import params_from_jax
from test_torch_port_sd_unet import tiny_sd_config

TOL = 2e-4
PROMPT = "a lighthouse at dusk"
SCHEDULERS = ("ddim", "euler", "dpm-solver")


def jax_trees():
    """(UNet config, VAE config, text config, UNet, VAE and text trees) of
    the JAX package, seeded."""
    ucfg, vcfg = tiny_sd_config(jax_unet, False), jax_vae.tiny_vae_config()
    tcfg = jax_clip.tiny_clip_config(hidden=32)
    return (ucfg, vcfg, tcfg, jax_unet.init_unet_params(jax.random.PRNGKey(0), ucfg),
            jax_vae.init_vae_params(jax.random.PRNGKey(1), vcfg),
            jax_clip.init_clip_params(jax.random.PRNGKey(2), tcfg))


@pytest.fixture(scope="module")
def trees():
    return jax_trees()


def _latents(seed=5):
    return np.random.RandomState(seed).randn(1, 16, 16, 4).astype(np.float32)


def _port(trees, scheduler, **fields):
    _, _, _, unet_p, vae_p, text_p = trees
    conv = lambda t: params_from_jax(jax.device_get(t))  # noqa: E731
    cfg = DistriConfig(device="cpu", height=128, width=128, warmup_steps=1, **fields)
    return DistriSDPipeline.from_params(
        cfg, tiny_sd_config(port_unet, False), conv(unet_p), port_vae.tiny_vae_config(),
        conv(vae_p), [port_clip.tiny_clip_config(hidden=32)], [conv(text_p)],
        scheduler=scheduler)


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_sd_latents_match_jax(trees, devices8, scheduler):
    ucfg, vcfg, tcfg, unet_p, vae_p, text_p = trees
    jcfg = JaxDistriConfig(devices=devices8[:1], height=128, width=128, warmup_steps=1)
    jpipe = JaxSDPipeline.from_params(jcfg, ucfg, unet_p, vcfg, vae_p, [tcfg], [text_p],
                                      scheduler=scheduler)
    kw = dict(num_inference_steps=3, guidance_scale=5.0, output_type="latent")
    want = np.asarray(jpipe(PROMPT, latents=_latents(), **kw).images[0])
    graphed = _port(trees, scheduler)
    assert graphed.distri_config.use_cuda_graph
    got = graphed(PROMPT, latents=_latents(), **kw).images[0]
    assert got.shape == want.shape == (16, 16, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    eager = _port(trees, scheduler, use_cuda_graph=False)(
        PROMPT, latents=_latents(), **kw).images[0]
    np.testing.assert_array_equal(got, eager)


def test_sd_image_matches_jax(trees, devices8):
    ucfg, vcfg, tcfg, unet_p, vae_p, text_p = trees
    jcfg = JaxDistriConfig(devices=devices8[:1], height=128, width=128)
    jpipe = JaxSDPipeline.from_params(jcfg, ucfg, unet_p, vcfg, vae_p, [tcfg], [text_p])
    kw = dict(num_inference_steps=2, output_type="np")
    want = np.asarray(jpipe(PROMPT, latents=_latents(6), **kw).images[0])
    got = _port(trees, "ddim")(PROMPT, latents=_latents(6), **kw).images[0]
    assert got.shape == want.shape == (32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_sd_encode_has_no_added_conditioning(trees):
    pipe = _port(trees, "ddim")
    emb, added = pipe._encode(["a", "b"], ["", ""])
    assert added is None and tuple(emb.shape) == (2, 2, 77, 32)


def test_sd_refuses_img2img_and_micro_conditioning(trees):
    """img2img, the handoff and the micro-conditioning keywords are part of
    the call now (the SD family ignores the micro-conditioning, as the JAX
    package does); a keyword the JAX pipeline does not take is still
    refused, and the image size is still the config's."""
    pipe = _port(trees, "ddim")
    kw = dict(num_inference_steps=2, output_type="latent")
    plain = pipe(PROMPT, latents=_latents(), **kw).images[0]
    micro = pipe(PROMPT, latents=_latents(), original_size=(64, 64), aesthetic_score=1.0,
                 **kw).images[0]
    np.testing.assert_array_equal(plain, micro)
    for kwargs in ({"guidance_rescale": 0.7}, {"strenght": 0.5}):
        with pytest.raises(TypeError, match="unexpected keyword arguments"):
            pipe(PROMPT, num_inference_steps=1, **kwargs)
    with pytest.raises(ValueError, match="fixed in DistriConfig"):
        pipe(PROMPT, num_inference_steps=1, height=64)


def test_sd_prepare_and_stepwise(trees):
    """``prepare`` (no capture on the CPU) and ``set_stepwise`` leave the
    latents unchanged, with Euler's scaled input in the static buffer."""
    pipe = _port(trees, "euler")
    kw = dict(num_inference_steps=3, output_type="latent")
    pipe.prepare(3)
    a = pipe(PROMPT, latents=_latents(), **kw).images[0]
    pipe.set_stepwise(True)
    b = pipe(PROMPT, latents=_latents(), **kw).images[0]
    np.testing.assert_array_equal(a, b)
    assert pipe.distri_config.use_cuda_graph is False


def test_sd_from_params_refuses_flow_euler(trees):
    with pytest.raises(ValueError, match="'flow-euler' on DistriSDPipeline"):
        _port(trees, "flow-euler")


def test_sd_config_fields_match_jax(trees):
    ucfg = trees[0]
    assert dataclasses.asdict(tiny_sd_config(port_unet, False)) == dataclasses.asdict(ucfg)
