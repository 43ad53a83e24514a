"""PyTorch port: the serve executors on the tiny pipelines.

The port's ``generate_batch`` takes the same latents as the JAX package's
and gives the same latents within the pipeline tests' tolerance (2e-4
absolute for SDXL as tests/test_torch_port_pipeline.py holds it, 5e-4 of
the largest value for PixArt-α as tests/test_torch_port_pixart.py does),
on weights seeded with the port's init and carried across with
``jax_layout`` (cheaper than the JAX package's op-by-op init) and back
with ``params_from_jax``.  Both refuse what the pre-bucketed entry
refuses, with the same messages.  A port `InferenceServer` over
`pipeline_executor_factory` serves three requests at ``batch_size=2`` and
each image equals the solo ``pipe(prompt, seed=s)`` call's bit for bit,
whatever batch it was coalesced into; the int8 key's executor (the
ladder's weight_quant_on rung, forced by ``apply_key_policy``) does the
same on its own pipeline.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu import pipelines as jax_pipelines
from distrifuser_tpu.models import clip as jax_clip
from distrifuser_tpu.models import unet as jax_unet
from distrifuser_tpu.models import vae as jax_vae
from distrifuser_tpu_torch import DistriConfig, DistriSDXLPipeline
from distrifuser_tpu_torch.models import clip as port_clip
from distrifuser_tpu_torch.models import unet as port_unet
from distrifuser_tpu_torch.models import vae as port_vae
from distrifuser_tpu_torch.models.weights import params_from_jax
from distrifuser_tpu_torch.parallel.compress import QuantizedTensor
from distrifuser_tpu_torch.serve import (ExecKey, InferenceServer, PipelineExecutor,
                                         ServeConfig, pipeline_executor_factory)
from test_torch_port_pixart import _jax_pipe as _jax_pixart
from test_torch_port_pixart import _port_pipe as _port_pixart
from test_torch_port_pixart import _close
from test_torch_port_pixart import dit, t5, trees  # noqa: F401 -- fixtures
from test_torch_port_pipeline import _text_configs
from test_torch_port_ranks import jax_layout

SDXL_TOL = 2e-4
PROMPTS = ["a lighthouse at dusk", "a corgi on a skateboard"]
STEPS = 2


@pytest.fixture(scope="module")
def sdxl_trees():
    """JAX-layout trees of the tiny SDXL pipeline, seeded with the port's init."""
    gen = torch.Generator().manual_seed(0)
    unet = jax_layout(port_unet.init_unet_params(
        gen, port_unet.tiny_config(cross_attention_dim=32, sdxl=True)))
    vae = jax_layout(port_vae.init_vae_params(gen, port_vae.tiny_vae_config()))
    text = [jax_layout(port_clip.init_clip_params(gen, tc))
            for tc in _text_configs(port_clip)]
    return unet, vae, text


def _jax_sdxl(devices8, trees):
    unet, vae, text = trees
    cfg = JaxDistriConfig(devices=devices8[:1], height=128, width=128, warmup_steps=1,
                          batch_size=2, use_cuda_graph=False)
    return jax_pipelines.DistriSDXLPipeline.from_params(
        cfg, jax_unet.tiny_config(cross_attention_dim=32, sdxl=True), unet,
        jax_vae.tiny_vae_config(), vae, _text_configs(jax_clip), text)


def _port_sdxl(trees, **fields):
    unet, vae, text = trees
    cfg = DistriConfig(device="cpu", height=128, width=128, warmup_steps=1, batch_size=2,
                       **fields)
    return DistriSDXLPipeline.from_params(
        cfg, port_unet.tiny_config(cross_attention_dim=32, sdxl=True),
        params_from_jax(unet), port_vae.tiny_vae_config(), params_from_jax(vae),
        _text_configs(port_clip), [params_from_jax(t) for t in text])


def _latents(seed=5):
    return np.random.RandomState(seed).randn(2, 16, 16, 4).astype(np.float32)


def test_sdxl_generate_batch_matches_jax(devices8, sdxl_trees):
    jpipe, ppipe = _jax_sdxl(devices8, sdxl_trees), _port_sdxl(sdxl_trees)
    kw = dict(num_inference_steps=STEPS, guidance_scale=5.0, output_type="latent")
    want = np.stack(jpipe.generate_batch(PROMPTS, latents=_latents(), **kw).images)
    got = np.stack(ppipe.generate_batch(PROMPTS, latents=_latents(), **kw).images)
    assert got.shape == want.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=SDXL_TOL)
    # the refusals of the pre-bucketed entry, message for message
    for call in (lambda p: p.generate_batch(PROMPTS[:1], **kw),
                 lambda p: p.generate_batch(PROMPTS, ["a", "b", "c"], **kw),
                 lambda p: p.generate_batch(PROMPTS, num_images_per_prompt=2, **kw)):
        msgs = []
        for pipe in (jpipe, ppipe):
            with pytest.raises(ValueError) as info:
                call(pipe)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]


def test_pixart_generate_batch_matches_jax(devices8, trees):  # noqa: F811
    jpipe = _jax_pixart(devices8, trees, "dpm-solver", use_cuda_graph=False)
    ppipe = _port_pixart(trees, "dpm-solver")
    kw = dict(num_inference_steps=STEPS, output_type="latent")
    want = np.stack(jpipe.generate_batch(PROMPTS, latents=_latents(7), **kw).images)
    got = np.stack(ppipe.generate_batch(PROMPTS, latents=_latents(7), **kw).images)
    _close(got, want)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _serve(pipe_for, requests, **config):
    """Serve ``requests`` ((prompt, seed) pairs) through a port server over
    ``pipeline_executor_factory(pipe_for)``; returns (results, executors)."""
    built = []

    def factory(key, _inner=pipeline_executor_factory(pipe_for)):
        built.append(_inner(key))
        return built[-1]

    config = ServeConfig(buckets=((128, 128),), max_batch_size=2, batch_window_s=0.3,
                         default_steps=STEPS, warmup_buckets=((128, 128),), **config)
    with InferenceServer(factory, config, model_id="tiny-sdxl") as server:
        futs = [server.submit(p, height=128, width=128, seed=s) for p, s in requests]
        results = [f.result(timeout=120) for f in futs]
    return results, built


REQUESTS = [(PROMPTS[0], 11), (PROMPTS[1], 12), ("a watercolor skyline", 13)]


def test_served_images_equal_solo_calls(sdxl_trees):
    pipe = _port_sdxl(sdxl_trees)
    results, built = _serve(lambda key: pipe, REQUESTS)
    assert len(built) == 1 and built[0].pipeline is pipe
    assert sorted(r.batch_size for r in results) == [1, 2, 2]
    assert all(r.compile_hit for r in results)
    for (prompt, seed), r in zip(REQUESTS, results):
        solo = pipe(prompt, seed=seed, num_inference_steps=STEPS, output_type="np").images[0]
        assert r.output.shape == (32, 32, 3) and np.isfinite(r.output).all()
        np.testing.assert_array_equal(r.output, solo)


def test_int8_key_executor_serves_bit_for_bit_with_its_solo_calls(sdxl_trees):
    """The ladder's weight_quant_on key against a dense builder:
    ``apply_key_policy`` quantizes the built tree and re-tags it for the
    kernel ("pallas"; its plain version on the CPU) before ``prepare``."""
    results, built = _serve(lambda key: _port_sdxl(sdxl_trees), REQUESTS[:2],
                            weight_quant="int8", quant_compute="pallas")
    (ex,) = built
    cfg = ex.pipeline.distri_config
    assert (cfg.weight_quant, cfg.quant_compute) == ("int8", "pallas")
    assert ex.key.short().endswith(":wq-int8:qc-pallas")
    assert any(isinstance(leaf, QuantizedTensor) for leaf in _leaves(ex.pipeline.runner.params))
    for (prompt, seed), r in zip(REQUESTS, results):
        solo = ex.pipeline(prompt, seed=seed, num_inference_steps=STEPS,
                           output_type="np").images[0]
        np.testing.assert_array_equal(r.output, solo)


def test_executor_draws_the_solo_noise_and_refuses_ranks(sdxl_trees):
    """The executor draws the solo call's noise; a pipeline whose config
    spans ranks, refused until step 16f, is accepted and serves."""
    pipe = _port_sdxl(sdxl_trees)
    ex = PipelineExecutor(pipe, STEPS)
    lat = ex._draw_latents([3, 4])
    for row, seed in zip(lat, (3, 4)):
        want = torch.randn((1, 16, 16, 4), generator=torch.Generator().manual_seed(seed))
        torch.testing.assert_close(row[None], want * pipe.scheduler.init_noise_sigma,
                                   rtol=0, atol=0)
    # refused until step 16f: a pipeline over ranks now gets an executor
    # (the one-rank pipeline under a config that says two ranks serves as
    # itself; tests/test_torch_port_serve_ranks.py serves over real ranks)
    ranked = copy.copy(pipe)
    ranked.distri_config = copy.copy(pipe.distri_config)
    ranked.distri_config.world_size = 2
    ex_ranked = PipelineExecutor(ranked, STEPS)
    assert ex_ranked.world_size == 2 and ex_ranked.batch_size == 2
    lat = ex_ranked._draw_latents([3])
    np.testing.assert_array_equal(
        ex_ranked(["a lighthouse"], [""], 5.0, [3])[0],
        pipe("a lighthouse", latents=lat, num_inference_steps=STEPS,
             output_type="np").images[0])
    step_key = ExecKey(model_id="m", scheduler="ddim", height=128, width=128, steps=2,
                       cfg=True, mesh_plan="dp1.cfg1.sp1", exec_mode="stepwise")
    factory = pipeline_executor_factory(lambda key: _port_sdxl(sdxl_trees))
    assert factory(step_key).pipeline.distri_config.use_cuda_graph is False
