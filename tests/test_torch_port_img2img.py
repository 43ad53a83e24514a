"""PyTorch port: img2img against the JAX package, and the VAE beneath it.

* The VAE encoder (``vae.encode``, the posterior mean) against the JAX
  ``encode`` on the tiny VAE, same weights through ``params_from_jax``:
  within 5e-4; the sampled posterior is the mean plus std times the
  generator's noise.
* The row-tiled decode against the JAX package's *tiled* decode,
  ``decode(..., tile=16)`` on a (1, 32, 8, 4) latent: within 5e-4 (and
  away from the whole decode, whose mid attention sees every row); the
  pipelines' decoder choice: a latent above 128 rows decodes in tiles of
  64 on one device, as the JAX ``_build_decoder`` picks, and whole where
  the JAX package would decode sequence-parallel.
* ``add_noise`` of DDIM, Euler and DPM++ 2M at several step indices:
  rtol 1e-4, atol 1e-5 (float32 on both sides).
* The tiny SDXL and SD pipelines, img2img at strength 0.5 of 4 steps (2
  steps run) for ddim, euler and dpm-solver, the JAX package's noise passed
  in: latents within 2e-4, the pipeline tolerance; the static-buffer step
  (``use_cuda_graph``, no capture on the CPU) equals the eager one bit for
  bit and counts only the steps that ran.
* ``stale_gn`` img2img at 2 gloo ranks (sp 2, warmup 1, strength 0.75 of 4
  steps: steps 1-3 run, 2 synchronous then 1 stale) against the JAX package
  on 2 fake devices: within 5e-4 of the latents' largest magnitude.
* ``weight_quant_aux`` quantizes the encoder as the JAX package does: the
  same bytes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.models import vae as jax_vae
from distrifuser_tpu.pipelines import DistriSDPipeline as JaxSDPipeline
from distrifuser_tpu.pipelines import DistriSDXLPipeline as JaxSDXLPipeline
from distrifuser_tpu.pipelines import _build_decoder, _decode_chunked
from distrifuser_tpu_torch import DistriConfig, DistriSDPipeline, DistriSDXLPipeline
from distrifuser_tpu_torch.models import vae as port_vae
from distrifuser_tpu_torch.models.weights import params_from_jax, params_nbytes
from distrifuser_tpu_torch.parallel.compress import QuantizedTensor
from distrifuser_tpu_torch.schedulers import get_scheduler as port_scheduler
from distrifuser_tpu_torch.utils import config as config_mod
from test_torch_port_ranks import run_ranks, sd_pipeline_worker
from test_torch_port_sd_pipeline import jax_trees

TOL = 2e-4  # pipeline latents (tests/test_torch_port_pipeline.py)
VAE_TOL = 5e-4
REL = 5e-4  # n ranks against the JAX package at n
PROMPT = "a lighthouse at dusk"
SCHEDULERS = ("ddim", "euler", "dpm-solver")
STEPS, STRENGTH = 4, 0.5


def _conv(tree):
    return params_from_jax(jax.device_get(tree))


@pytest.fixture(scope="module")
def vae_trees():
    cfg = jax_vae.tiny_vae_config()
    jp = jax_vae.init_vae_params(jax.random.PRNGKey(1), cfg)
    return cfg, jp, _conv(jp)


def _image(seed=7, shape=(32, 32, 3)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_vae_encode_matches_jax(vae_trees, monkeypatch):
    cfg, jp, pp = vae_trees
    img = np.random.RandomState(0).uniform(-1, 1, (2, 32, 24, 3)).astype(np.float32)
    want = np.asarray(jax_vae.encode(jp, cfg, jnp.asarray(img)))
    got = port_vae.encode(pp, port_vae.tiny_vae_config(), torch.from_numpy(img))
    assert tuple(got.shape) == want.shape == (2, 16, 12, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=VAE_TOL)
    # with a generator: the mean plus the posterior's std times its draw
    convs = []
    conv2d = port_vae.conv2d
    monkeypatch.setattr(port_vae, "conv2d",
                        lambda *a, **k: convs.append(conv2d(*a, **k)) or convs[-1])
    sample = port_vae.encode(pp, port_vae.tiny_vae_config(), torch.from_numpy(img),
                             generator=torch.Generator().manual_seed(3))
    logvar = convs[-1].chunk(2, dim=-1)[1]  # quant_conv's moments
    noise = torch.randn(got.shape, generator=torch.Generator().manual_seed(3))
    want_sample = got + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise
    assert not torch.equal(sample, got)
    torch.testing.assert_close(sample, want_sample, rtol=0, atol=1e-6)


def test_vae_downsample_pads_bottom_right(vae_trees):
    """The downsample pads one row and one column at the far edges, then
    convolves 3x3 at stride 2 without padding: a symmetric padding=1
    conv gives other values."""
    _, _, pp = vae_trees
    p = pp["encoder"]["down_blocks"][0]["downsamplers"][0]
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 8, 6, 16).astype(np.float32))
    got = port_vae._downsample(p, x)
    want = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1)),
        p["conv"]["kernel"], p["conv"]["bias"], stride=2).permute(0, 2, 3, 1)
    assert tuple(got.shape) == (1, 4, 3, 16)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    symmetric = port_vae.conv2d(p["conv"], x, stride=2, padding=1)
    assert (symmetric - got).abs().max() > 1e-3


def test_tiled_decode_matches_jax_tiled(vae_trees):
    cfg, jp, pp = vae_trees
    lat = np.random.RandomState(1).randn(1, 32, 8, 4).astype(np.float32)
    want = np.asarray(jax_vae.decode(jp, cfg, jnp.asarray(lat), tile=16))
    got = port_vae.decode(pp, port_vae.tiny_vae_config(), torch.from_numpy(lat), tile=16)
    assert tuple(got.shape) == want.shape == (1, 64, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=VAE_TOL)
    whole = port_vae.decode(pp, port_vae.tiny_vae_config(), torch.from_numpy(lat))
    assert np.abs(whole.numpy() - want).max() > 10 * VAE_TOL  # the tiles, not the whole
    # a latent no taller than a tile decodes whole
    short = torch.from_numpy(lat[:, :16])
    torch.testing.assert_close(port_vae.decode(pp, port_vae.tiny_vae_config(), short,
                                               tile=16),
                               port_vae.decode(pp, port_vae.tiny_vae_config(), short))


@pytest.mark.parametrize("name", SCHEDULERS)
def test_add_noise_matches_jax(name):
    from distrifuser_tpu.schedulers import get_scheduler as jax_scheduler

    rs = np.random.RandomState(4)
    x0 = rs.randn(2, 8, 8, 4).astype(np.float32)
    eps = rs.randn(2, 8, 8, 4).astype(np.float32)
    js, ps = jax_scheduler(name).set_timesteps(10), port_scheduler(name).set_timesteps(10)
    for i in (0, 3, 5, 9):
        want = np.asarray(js.add_noise(jnp.asarray(x0), jnp.asarray(eps), i))
        got = ps.add_noise(torch.from_numpy(x0), torch.from_numpy(eps), i)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_euler_add_noise_is_sigma_space():
    """Euler's img2img latent is x0 + sigma * eps, not scaled again by
    ``init_noise_sigma``."""
    s = port_scheduler("euler").set_timesteps(4)
    x0, eps = torch.zeros(1, 2, 2, 4), torch.ones(1, 2, 2, 4)
    assert torch.allclose(s.add_noise(x0, eps, 2), s._sigmas[2].expand(1, 2, 2, 4))
    assert s.init_noise_sigma > float(s._sigmas[2])


def _jax_noise(seed, shape):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


def _sdxl_pair(devices8, scheduler, **unet_fields):
    """(the tiny JAX SDXL pipeline, a function building the port's from the
    same weights with extra config fields); ``unet_fields`` change the
    UNet config of both (a refiner-style add embedding)."""
    from distrifuser_tpu.models import clip as jax_clip
    from distrifuser_tpu.models import unet as jax_unet
    from distrifuser_tpu_torch.models import clip as port_clip
    from distrifuser_tpu_torch.models import unet as port_unet
    from test_torch_port_pipeline import _text_configs

    ucfg = dataclasses.replace(jax_unet.tiny_config(cross_attention_dim=32, sdxl=True),
                               **unet_fields)
    vcfg = jax_vae.tiny_vae_config()
    tcfgs = _text_configs(jax_clip)
    unet_p = jax_unet.init_unet_params(jax.random.PRNGKey(0), ucfg)
    vae_p = jax_vae.init_vae_params(jax.random.PRNGKey(1), vcfg)
    text_p = [jax_clip.init_clip_params(jax.random.PRNGKey(2 + i), tc)
              for i, tc in enumerate(tcfgs)]
    jcfg = JaxDistriConfig(devices=devices8[:1], height=128, width=128, warmup_steps=1)
    jpipe = JaxSDXLPipeline.from_params(jcfg, ucfg, unet_p, vcfg, vae_p, tcfgs, text_p,
                                        scheduler=scheduler)

    def port(**fields):
        cfg = DistriConfig(device="cpu", height=128, width=128, warmup_steps=1, **fields)
        pcfg = dataclasses.replace(port_unet.tiny_config(cross_attention_dim=32, sdxl=True),
                                   **unet_fields)
        return DistriSDXLPipeline.from_params(
            cfg, pcfg, _conv(unet_p),
            port_vae.tiny_vae_config(), _conv(vae_p), _text_configs(port_clip),
            [_conv(p) for p in text_p], scheduler=scheduler)

    return jpipe, port


def _sd_pair(devices8, scheduler):
    from test_torch_port_sd_pipeline import _port

    trees = jax_trees()
    ucfg, vcfg, tcfg, unet_p, vae_p, text_p = trees
    jcfg = JaxDistriConfig(devices=devices8[:1], height=128, width=128, warmup_steps=1)
    jpipe = JaxSDPipeline.from_params(jcfg, ucfg, unet_p, vcfg, vae_p, [tcfg], [text_p],
                                      scheduler=scheduler)
    return jpipe, lambda **fields: _port(trees, scheduler, **fields)


@pytest.mark.parametrize("family", ("sdxl", "sd"))
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_img2img_latents_match_jax(devices8, family, scheduler):
    jpipe, port = (_sdxl_pair if family == "sdxl" else _sd_pair)(devices8, scheduler)
    image = _image()
    if scheduler == "euler":  # the uint8 form of the same input range
        image = (image * 255).round().astype(np.uint8)
    kw = dict(image=image, strength=STRENGTH, num_inference_steps=STEPS, seed=11,
              output_type="latent")
    want = np.asarray(jpipe(PROMPT, **kw).images[0])
    noise = _jax_noise(11, (1, 16, 16, 4))
    graphed = port()
    seen = []
    got = graphed(PROMPT, _noise=noise, callback=lambda i, t, x: seen.append(i),
                  **kw).images[0]
    assert got.shape == want.shape == (16, 16, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert seen == [2, 3]  # absolute step indices of the 2 steps that ran
    assert graphed.runner.phase_counts == {"sync": 2, "stale": 0}
    eager = port(use_cuda_graph=False)(PROMPT, _noise=noise, **kw).images[0]
    np.testing.assert_array_equal(got, eager)


def test_img2img_prompt_major_expansion(devices8):
    """One image over two prompts and two images a prompt: each prompt's
    images adjacent, as the prompts expand; the seeded torch noise
    differs per image and repeats per seed."""
    _, port = _sd_pair(devices8, "ddim")
    pipe = port()
    kw = dict(image=_image(), strength=1.0, num_inference_steps=2, output_type="latent")
    a = np.stack(pipe(["a cabin", "a boat"], num_images_per_prompt=2, seed=1,
                      **kw).images)
    b = np.stack(pipe(["a cabin", "a boat"], num_images_per_prompt=2, seed=1,
                      **kw).images)
    assert a.shape == (4, 16, 16, 4) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert np.abs(a[0] - a[1]).max() > 0
    noise = np.random.RandomState(0).randn(4, 16, 16, 4).astype(np.float32)
    split = [pipe(p, image=_image(), strength=1.0, num_inference_steps=2,
                  output_type="latent", _noise=noise[2 * j:2 * j + 2],
                  num_images_per_prompt=2).images for j, p in enumerate(["a cabin", "a boat"])]
    joint = pipe(["a cabin", "a boat"], num_images_per_prompt=2, _noise=noise,
                 **{k: v for k, v in kw.items()}).images
    np.testing.assert_array_equal(np.stack(joint), np.stack(split[0] + split[1]))


def test_img2img_refusals(devices8):
    _, port = _sd_pair(devices8, "ddim")
    pipe = port()
    kw = dict(num_inference_steps=2, output_type="latent")
    with pytest.raises(ValueError, match="not both"):
        pipe(PROMPT, image=_image(), latents=np.zeros((1, 16, 16, 4), np.float32), **kw)
    with pytest.raises(ValueError, match=r"uint8 \[0,255\] or float \[0,1\]"):
        pipe(PROMPT, image=_image() * 2 - 1, **kw)
    with pytest.raises(ValueError, match="strength"):
        pipe(PROMPT, image=_image(), strength=0.0, **kw)
    with pytest.raises(ValueError, match="encodes to"):
        pipe(PROMPT, image=_image(shape=(16, 16, 3)), **kw)
    with pytest.raises(ValueError, match="3 init images for 1 prompts"):
        pipe(PROMPT, image=np.stack([_image()] * 3), **kw)


def _world(monkeypatch, world):
    """A DistriConfig at ``world`` ranks without process groups (the
    decoder choice reads only the geometry)."""
    monkeypatch.setattr(config_mod, "_world_and_rank", lambda: (world, 0))
    monkeypatch.setattr(config_mod, "_process_groups", lambda w, n, r, dp: ("batch", None, None))


@pytest.mark.parametrize("world, fields, tile", [
    (1, {}, 64),  # one device above 1024 px: tiles of 64
    (2, {"split_batch": False}, 0),  # sp 2 with vae_sp: both decode sequence-parallel
    (2, {"split_batch": False, "vae_sp": False}, 64),
    (2, {"split_batch": False, "parallelism": "tensor"}, 64),  # not in patches
])
def test_decoder_choice_follows_jax(devices8, monkeypatch, world, fields, tile):
    from distrifuser_tpu_torch.models import clip as port_clip
    from distrifuser_tpu_torch.models import unet as port_unet
    from test_torch_port_sd_unet import tiny_sd_config

    trees = jax_trees()
    vcfg = trees[1]
    jcfg = JaxDistriConfig(devices=devices8[:world], height=1152, width=64, **fields)
    _, jax_parallel = _build_decoder(jcfg, vcfg)
    _world(monkeypatch, world)
    cfg = DistriConfig(device="cpu", height=1152, width=64, use_cuda_graph=False, **fields)
    pipe = DistriSDPipeline.from_params(
        cfg, tiny_sd_config(port_unet, False), _conv(trees[3]), port_vae.tiny_vae_config(),
        _conv(trees[4]), [port_clip.tiny_clip_config(hidden=32)], [_conv(trees[5])])
    assert pipe.vae_decode_tile == tile and jax_parallel == (tile == 0)
    assert pipe.vae_decode_parallel == jax_parallel
    if jax_parallel:
        # decoded by the patch group's ranks: test_torch_port_vae_sp.py
        # holds the pipeline's sequence-parallel decode at 2 gloo ranks
        return
    # the 1152-px image (144 latent rows) decodes as the JAX package's one
    # device decodes it, in tiles
    lat = np.random.RandomState(3).randn(1, 144, 8, 4).astype(np.float32)
    decode = _build_decoder(JaxDistriConfig(devices=devices8[:1], height=1152, width=64),
                            vcfg)[0]
    want = np.clip(np.asarray(_decode_chunked(decode, trees[4], jnp.asarray(lat), 1,
                                              vcfg.scaling_factor)) / 2 + 0.5, 0, 1)
    got = pipe._decode_to_np(torch.from_numpy(lat))
    assert got.shape == want.shape == (1, 288, 16, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=VAE_TOL)


def test_weight_quant_aux_covers_the_encoder(devices8):
    ucfg, vcfg, tcfg, unet_p, vae_p, text_p = jax_trees()
    jcfg = JaxDistriConfig(devices=devices8[:1], height=128, width=128,
                           weight_quant_aux="int8")
    jpipe = JaxSDPipeline.from_params(jcfg, ucfg, unet_p, vcfg, vae_p, [tcfg], [text_p])
    from test_torch_port_sd_pipeline import _port

    pipe = _port(jax_trees(), "ddim", weight_quant_aux="int8")
    enc = pipe.vae_params["encoder"]
    assert isinstance(enc["conv_in"]["kernel"], QuantizedTensor)
    assert isinstance(enc["mid_block"]["attentions"][0]["to_q"]["kernel"], QuantizedTensor)
    assert not isinstance(enc["conv_out"]["kernel"], QuantizedTensor)  # an output head
    assert isinstance(pipe.vae_params["quant_conv"]["kernel"], QuantizedTensor)
    assert (pipe.weight_report()["per_component_nbytes"]["vae"]
            == jpipe.weight_report()["per_component_nbytes"]["vae"]
            == params_nbytes(pipe.vae_params))
    out = pipe(PROMPT, image=_image(), strength=0.5, num_inference_steps=2,
               output_type="latent").images[0]
    assert np.isfinite(out).all()


IMG2IMG_CASES = [{"mode": "stale_gn", "warmup_steps": 1, "split_batch": False,
                  "use_cuda_graph": g} for g in (False, True)]


def _key(case):
    return tuple(sorted(case.items()))


def test_stale_gn_img2img_world2_matches_jax(devices8, tmp_path):
    """sp 2, warmup 1, strength 0.75 of 4 DPM++ 2M steps: steps 1-3 run,
    the first two synchronous (counted from the first step that runs), the
    last stale."""
    ucfg, vcfg, tcfg, unet_p, vae_p, text_p = jax_trees()
    image = _image(9)
    call = {"image": torch.from_numpy(image), "strength": 0.75, "num_inference_steps": 4,
            "seed": 2, "_noise": torch.from_numpy(_jax_noise(2, (1, 16, 16, 4)))}
    torch.save({"cases": IMG2IMG_CASES, "unet_config": dataclasses.asdict(ucfg),
                "vae_config": dataclasses.asdict(vcfg),
                "text_config": dataclasses.asdict(tcfg), "unet": _conv(unet_p),
                "vae": _conv(vae_p), "text": _conv(text_p), "prompt": PROMPT,
                "scheduler": "dpm-solver", "latents": None, "call": call},
               tmp_path / "sd.pt")
    run_ranks(2, sd_pipeline_worker, tmp_path, str(tmp_path / "sd.pt"),
              str(tmp_path / "out"))
    port = [torch.load(f"{tmp_path / 'out'}.rank{r}", weights_only=False) for r in range(2)]
    jcfg = JaxDistriConfig(devices=devices8[:2], height=128, width=128, warmup_steps=1,
                           mode="stale_gn", split_batch=False)
    jpipe = JaxSDPipeline.from_params(jcfg, ucfg, unet_p, vcfg, vae_p, [tcfg], [text_p],
                                      scheduler="dpm-solver")
    want = np.asarray(jpipe(PROMPT, image=image, strength=0.75, num_inference_steps=4,
                            seed=2, output_type="latent").images[0])
    for case in IMG2IMG_CASES:
        latents = [r[_key(case)][0] for r in port]
        np.testing.assert_array_equal(latents[0], latents[1])
        np.testing.assert_allclose(latents[0], want, rtol=0, atol=REL * np.abs(want).max())
        assert port[0][_key(case)][1] == {"sync": 2, "stale": 1}
    np.testing.assert_array_equal(port[0][_key(IMG2IMG_CASES[0])][0],
                                  port[0][_key(IMG2IMG_CASES[1])][0])
