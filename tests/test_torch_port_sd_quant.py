"""PyTorch port: SD 1.5's quantized pipeline against the JAX package.

The SD 1.5-shaped tiny pipeline (conv projections), int8 and fp8 with
``quant_compute="pallas"``, the same dense weights in both packages:

* both quantize them to the same payloads and scales;
* every int8 linear of its UNet, given the activation the JAX forward gave
  it, equals the JAX one bit for bit (the helper of
  tests/test_torch_port_quant_pipeline.py);
* the pipeline's latents after 3 DDIM steps are within 2e-4 of the JAX
  pipeline's where the payloads densify ("off", so no per-token rounding),
  and within the SDXL quantized pipeline's limits under "pallas" (relative
  L2 4e-2, max 0.5; measured 2.1e-2 and 0.24 int8, 2.2e-2 and 0.29 fp8, on
  latents reaching |14|): per-token activation rounding turns float32
  last-bit differences into whole quantization steps.
"""

import jax
import numpy as np
import pytest
import torch

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.pipelines import DistriSDPipeline as JaxSDPipeline
from distrifuser_tpu_torch.models import unet as port_unet
from distrifuser_tpu_torch.models.weights import params_from_jax
from distrifuser_tpu_torch.parallel.compress import QuantizedTensor
from test_torch_port_quant_pipeline import (PIPE_MAX, PIPE_REL_L2, PROMPT,
                                            _check_per_linear, _latents, _unet_inputs)
from test_torch_port_sd_pipeline import _port
from test_torch_port_sd_pipeline import jax_trees as sd_jax_trees
from test_torch_port_sd_unet import tiny_sd_config


def _quantized_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _quantized_leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _quantized_leaves(v)
    elif isinstance(tree, QuantizedTensor):
        yield tree


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_sd15_quantized_pipeline_matches_jax(devices8, mode):
    trees = sd_jax_trees()
    ucfg, vcfg, tcfg, unet_p, vae_p, text_p = trees
    quant = dict(weight_quant=mode, quant_compute="pallas")
    jcfg = JaxDistriConfig(devices=devices8[:1], height=128, width=128, warmup_steps=1,
                           **quant)
    jpipe = JaxSDPipeline.from_params(jcfg, ucfg, unet_p, vcfg, vae_p, [tcfg], [text_p])
    ppipe = _port(trees, "ddim", **quant)
    # the same payloads and scales from the same dense weights
    want_tree = params_from_jax(jax.device_get(jpipe.runner.params))
    pairs = list(zip(_quantized_leaves(ppipe.runner.params),
                     _quantized_leaves(want_tree)))
    assert len(pairs) > 20
    for got, want in pairs:
        assert got.mode == want.mode == mode and got.compute == "pallas"
        assert torch.equal(got.payload.view(torch.uint8), want.payload.view(torch.uint8))
        assert torch.equal(got.scale, want.scale)
    if mode == "int8":  # the GEMM bit for bit, per linear on JAX's activations
        _check_per_linear(jpipe.runner.params, ucfg, ppipe.runner.params,
                          tiny_sd_config(port_unet, False), _unet_inputs(False), mode,
                          "pallas")
    kw = dict(num_inference_steps=3, guidance_scale=5.0, output_type="latent")
    want = np.asarray(jpipe(PROMPT, latents=_latents(), **kw).images[0])
    got = ppipe(PROMPT, latents=_latents(), **kw).images[0]
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= PIPE_REL_L2 and np.abs(got - want).max() <= PIPE_MAX, rel
    jpipe.set_quant_compute("off")
    ppipe.set_quant_compute("off")
    want = np.asarray(jpipe(PROMPT, latents=_latents(), **kw).images[0])
    got = ppipe(PROMPT, latents=_latents(), **kw).images[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)

