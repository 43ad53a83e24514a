"""PyTorch port: the quantized UNet and SDXL pipeline against the JAX
package, on the CPU in float32.

The same JAX-quantized payloads (through ``params_from_jax``) and the same
numpy inputs go through both packages.

* Route "dequant": the dense gate, 5e-4 (measured 3.2e-6).
* Routes "dot" and "pallas" quantize every activation per token, so a
  last-bit difference upstream (float32 sum order in a norm or a conv)
  can flip one element's rounding by one quantization step, and the flip
  grows through later layers: whole forwards differ by up to 0.13 on
  outputs of magnitude 2.8 (fp8, SD; 0.03 int8), which is also how far the
  JAX package's own "dot" and "pallas" routes differ from each other on
  the same forward (0.028 int8, 0.073 fp8, SDXL).  So these routes are
  held per linear, on identical inputs: every quantized linear of a
  forward gets the activation the JAX forward gave it, and the port's
  output must equal JAX's exactly for int8 and within 1e-6 * max |y| for
  fp8 (1.4e-7 measured).  The whole forward is held to the JAX package's
  own quantized-compute tolerance for the UNet (tests/test_quant_compute.py,
  int8 0.12, fp8 0.5).
* Tiny SDXL pipeline, 3 DDIM steps, weight_quant and weight_quant_aux
  int8, port "pallas" against JAX "pallas" (interpret mode) on the same
  latents: relative L2 <= 4e-2 and max |d| <= 0.5 on latents reaching
  |13| (measured 1.7e-2 and 0.23, the same per-token rounding flips).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.models import clip as jax_clip
from distrifuser_tpu.models import unet as jax_unet
from distrifuser_tpu.models import vae as jax_vae
from distrifuser_tpu.models.weights import quantize_params as jax_quantize_params
from distrifuser_tpu.pipelines import DistriSDXLPipeline as JaxSDXLPipeline
from distrifuser_tpu_torch import DistriConfig, DistriSDXLPipeline
from distrifuser_tpu_torch.models import clip as port_clip
from distrifuser_tpu_torch.models import unet as port_unet
from distrifuser_tpu_torch.models import vae as port_vae
from distrifuser_tpu_torch.models.weights import params_from_jax

jax_linear = importlib.import_module("distrifuser_tpu.ops.linear")
port_linear = importlib.import_module("distrifuser_tpu_torch.ops.linear")

DENSE_GATE = 5e-4
PER_LINEAR_FP8 = 1e-6
WHOLE_FORWARD = {"int8": 0.12, "fp8": 0.5}
PIPE_REL_L2, PIPE_MAX = 4e-2, 0.5
PROMPT = "a lighthouse at dusk"


def _unet_inputs(sdxl, seed=0):
    r = np.random.RandomState(seed)
    sample = r.randn(2, 16, 16, 4).astype(np.float32)
    enc = r.randn(2, 8, 32).astype(np.float32)
    t = np.array([981, 501], np.int64)
    added = None
    if sdxl:
        added = {"text_embeds": r.randn(2, 32).astype(np.float32),
                 "time_ids": np.tile(np.array([128, 128, 0, 0, 128, 128],
                                              np.float32), (2, 1))}
    return sample, t, enc, added


def _jax_forward(q, jcfg, inputs):
    sample, t, enc, added = inputs
    return jax_unet.unet_forward(
        q, jcfg, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(enc),
        added_cond=None if added is None else jax.tree.map(jnp.asarray, added))


def _port_forward(pq, pcfg, inputs):
    sample, t, enc, added = inputs
    return port_unet.unet_forward(
        pq, pcfg, torch.from_numpy(sample), torch.from_numpy(t), torch.from_numpy(enc),
        added_cond=None if added is None else
        {k: torch.from_numpy(v) for k, v in added.items()}).numpy()


def _record(module, to_numpy, run):
    """Run ``run()`` with ``module._quantized_matmul`` recording its
    (activation, output) pairs."""
    calls, orig = [], module._quantized_matmul

    def recording(x, qt):
        y = orig(x, qt)
        calls.append((to_numpy(x), to_numpy(y)))
        return y

    module._quantized_matmul = recording
    try:
        run()
    finally:
        module._quantized_matmul = orig
    return calls


@pytest.mark.parametrize("route", ["dequant", "dot", "pallas"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("sdxl", [True, False], ids=["sdxl", "sd"])
def test_quantized_unet_matches_jax(sdxl, mode, route):
    jcfg = jax_unet.tiny_config(cross_attention_dim=32, sdxl=sdxl)
    pcfg = port_unet.tiny_config(cross_attention_dim=32, sdxl=sdxl)
    jq = jax_quantize_params(jax_unet.init_unet_params(jax.random.PRNGKey(0), jcfg),
                             mode, compute=route)
    pq = params_from_jax(jax.device_get(jq))
    inputs = _unet_inputs(sdxl)
    want = np.asarray(_jax_forward(jq, jcfg, inputs))
    got = _port_forward(pq, pcfg, inputs)
    assert got.shape == want.shape == (2, 16, 16, 4)
    if route == "dequant":
        np.testing.assert_allclose(got, want, rtol=DENSE_GATE, atol=DENSE_GATE)
        return
    assert np.abs(got - want).max() <= WHOLE_FORWARD[mode]

    # per linear, on the activations of the JAX forward
    with jax.disable_jit():
        jax_calls = _record(jax_linear, np.asarray,
                            lambda: _jax_forward(jq, jcfg, inputs))
    port_qts = []
    orig = port_linear._quantized_matmul
    port_linear._quantized_matmul = lambda x, qt: (port_qts.append(qt), orig(x, qt))[1]
    try:
        _port_forward(pq, pcfg, inputs)
    finally:
        port_linear._quantized_matmul = orig
    assert len(jax_calls) == len(port_qts) > 0
    for (x, y), qt in zip(jax_calls, port_qts):
        assert qt.compute == route
        same = orig(torch.from_numpy(np.array(x)), qt).numpy()
        if mode == "int8":
            np.testing.assert_array_equal(same, y)
        else:
            np.testing.assert_allclose(same, y, rtol=0,
                                       atol=PER_LINEAR_FP8 * np.abs(y).max())


def _text_configs(mod):
    return [
        mod.tiny_clip_config(hidden=16),
        mod.CLIPTextConfig(vocab_size=1000, hidden_size=16, num_hidden_layers=2,
                           num_attention_heads=4, intermediate_size=32,
                           projection_dim=32),
    ]


@pytest.fixture(scope="module")
def jax_trees():
    ucfg = jax_unet.tiny_config(cross_attention_dim=32, sdxl=True)
    vcfg = jax_vae.tiny_vae_config()
    tcfgs = _text_configs(jax_clip)
    unet_p = jax_unet.init_unet_params(jax.random.PRNGKey(0), ucfg)
    vae_p = jax_vae.init_vae_params(jax.random.PRNGKey(1), vcfg)
    text_p = [jax_clip.init_clip_params(jax.random.PRNGKey(2 + i), tc)
              for i, tc in enumerate(tcfgs)]
    return (ucfg, unet_p), (vcfg, vae_p), (tcfgs, text_p)


def _port_pipeline(jax_trees, **cfg_kw):
    (_, unet_p), (_, vae_p), (_, text_p) = jax_trees
    cfg = DistriConfig(device="cpu", height=128, width=128, **cfg_kw)
    return DistriSDXLPipeline.from_params(
        cfg, port_unet.tiny_config(cross_attention_dim=32, sdxl=True),
        params_from_jax(jax.device_get(unet_p)), port_vae.tiny_vae_config(),
        params_from_jax(jax.device_get(vae_p)), _text_configs(port_clip),
        [params_from_jax(jax.device_get(p)) for p in text_p],
    )


def _latents(seed=5):
    return np.random.RandomState(seed).randn(1, 16, 16, 4).astype(np.float32)


def test_quantized_sdxl_pipeline_matches_jax(jax_trees, devices8):
    (ucfg, unet_p), (vcfg, vae_p), (tcfgs, text_p) = jax_trees
    quant = dict(weight_quant="int8", weight_quant_aux="int8", quant_compute="pallas")
    jcfg = JaxDistriConfig(devices=devices8[:1], height=128, width=128,
                           warmup_steps=1, **quant)
    jpipe = JaxSDXLPipeline.from_params(jcfg, ucfg, unet_p, vcfg, vae_p, tcfgs, text_p)
    ppipe = _port_pipeline(jax_trees, warmup_steps=1, **quant)
    kw = dict(num_inference_steps=3, guidance_scale=5.0, output_type="latent")
    want = np.asarray(jpipe(PROMPT, latents=_latents(), **kw).images[0])
    got = ppipe(PROMPT, latents=_latents(), **kw).images[0]
    assert got.shape == want.shape == (16, 16, 4) and np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= PIPE_REL_L2 and np.abs(got - want).max() <= PIPE_MAX, rel
    # quantized weights: the aux models hold payloads that densify at use
    rep = ppipe.weight_report()
    assert (rep["weight_quant"], rep["weight_quant_aux"], rep["quant_compute"]) == (
        "int8", "int8", "pallas")
    assert ppipe.runner.params["down_blocks"][1]["attentions"][0]["proj_in"][
        "kernel"].compute == "pallas"
    assert ppipe.vae_params["decoder"]["conv_in"]["kernel"].compute == "dequant"


def test_pipeline_quant_compute_hooks(jax_trees):
    pipe = _port_pipeline(jax_trees, weight_quant="int8")
    dense = _port_pipeline(jax_trees)
    rep = pipe.weight_report()
    assert rep["quant_compute"] == "auto" and rep["weight_quant"] == "int8"
    assert set(rep["per_component_nbytes"]) == {"denoiser", "vae", "text_encoders"}
    assert rep["total_bytes"] == sum(rep["per_component_nbytes"].values())
    drep = dense.weight_report()
    assert rep["per_component_nbytes"]["denoiser"] < \
        drep["per_component_nbytes"]["denoiser"] / 3  # 1-byte payloads, fp32 dense
    assert rep["per_component_nbytes"]["vae"] == drep["per_component_nbytes"]["vae"]

    def gen(p):
        return p(PROMPT, num_inference_steps=1, seed=5, guidance_scale=1.0,
                 output_type="np").images[0].astype(np.float64)

    auto = gen(pipe)  # on the CPU "auto" densifies: storage numerics
    pipe.set_quant_compute("off")
    np.testing.assert_array_equal(gen(pipe), auto)
    pipe.set_quant_compute("dot")
    assert pipe.weight_report()["quant_compute"] == "dot"
    assert np.abs(gen(pipe) - auto).max() <= 2e-2
    with pytest.raises(ValueError, match="no quantized kernels"):
        dense.set_quant_compute("pallas")
    with pytest.raises(ValueError, match="cannot switch"):
        pipe.set_weight_quant("fp8")
    with pytest.raises(ValueError, match="cannot switch"):
        pipe.set_weight_quant("none")
    pipe.set_weight_quant("int8")  # same mode: nothing to do
    dense.set_weight_quant("fp8")
    assert dense.weight_report()["weight_quant"] == "fp8"
    assert dense.runner.params["conv_in"]["kernel"].mode == "fp8"
