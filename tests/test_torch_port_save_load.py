"""PyTorch port: the quantized ``.npz`` save and load (ROADMAP item 12,
``models/weights.py`` ``save_params`` / ``load_params``) against the JAX
package's.

* The same JAX tree -- the tiny SDXL UNet and the tiny DiT (blocks stacked
  on a leading axis), dense bf16, int8 and fp8 at ``channel_tile`` 1 and 3
  -- goes through the JAX ``save_params`` -> ``load_params`` ->
  ``params_from_jax``, and through ``params_from_jax`` -> the port's
  ``save_params`` -> ``load_params``.  Both trees, and the port's tree
  before its save, are equal bit for bit: every leaf's dtype, shape,
  strides (channels_last convs, column-major linear payloads) and bytes,
  each quantized leaf's scale, compute dtype and ``channel_tile``; stacked
  blocks come back as lists.
* Each refusal of the JAX ``load_params`` (an explicit dtype against a
  quantized archive's, an archive that mixes compute dtypes) is raised
  alike, with the same text.
* A tiny SDXL pipeline built from a reloaded int8 UNet tree gives the
  latents of the pipeline whose tree was saved, bit for bit (float32, the
  CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrifuser_tpu.models import weights as jax_weights
from distrifuser_tpu.parallel.compress import quantize_weight as jax_quantize_weight
from distrifuser_tpu_torch.models import dit as port_dit
from distrifuser_tpu_torch.models import unet as port_unet
from distrifuser_tpu_torch.models.weights import (load_params, params_from_jax,
                                                  quantize_params, save_params)
from distrifuser_tpu_torch.parallel.compress import QuantizedTensor
from test_torch_port_pixart import jax_tree

CASES = [("bf16", None, 1), ("int8", "int8", 1), ("int8", "int8", 3),
         ("fp8", "fp8", 1), ("fp8", "fp8", 3)]


@pytest.fixture(scope="module")
def jax_trees():
    """The tiny SDXL UNet's and the tiny DiT's trees as the JAX package
    holds them, seeded with the port's init."""
    gen = torch.Generator().manual_seed(5)
    unet = port_unet.init_unet_params(gen, port_unet.tiny_config(cross_attention_dim=32,
                                                                 sdxl=True))
    dit = port_dit.init_dit_params(gen, port_dit.tiny_dit_config(depth=2))
    return {"unet": jax_tree(unet), "dit": jax_tree(dit)}


def _bytes(t: torch.Tensor) -> bytes:
    return t.clone(memory_format=torch.contiguous_format).view(torch.uint8).numpy().tobytes()


def _assert_same(got, want, path="tree"):
    """Bit for bit, layout included."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}.{i}")
    elif isinstance(want, QuantizedTensor):
        assert isinstance(got, QuantizedTensor), path
        assert (got.dtype, got.channel_tile, got.compute) == (
            want.dtype, want.channel_tile, want.compute), path
        _assert_same(got.payload, want.payload, path + ".payload")
        _assert_same(got.scale, want.scale, path + ".scale")
    else:
        assert (got.dtype, tuple(got.shape), got.stride()) == (
            want.dtype, tuple(want.shape), want.stride()), path
        assert _bytes(got) == _bytes(want), path


def _jax_quantized(tree, mode, tile):
    tree = jax_weights._cast(tree, jnp.bfloat16) if mode is None else tree
    if mode is None:
        return tree
    return jax_weights.quantize_params(tree, mode, channel_tile=tile)


@pytest.mark.parametrize("model", ("unet", "dit"))
@pytest.mark.parametrize("name,mode,tile", CASES, ids=[f"{c[0]}-tile{c[2]}" for c in CASES])
def test_round_trip_equals_jax_bit_for_bit(jax_trees, tmp_path, model, name, mode, tile):
    jtree = _jax_quantized(jax_trees[model], mode, tile)
    dtype = (jnp.bfloat16, torch.bfloat16) if mode is None else (None, None)
    jax_weights.save_params(str(tmp_path / "jax.npz"), jtree)
    want = params_from_jax(jax_weights.load_params(str(tmp_path / "jax.npz"), dtype[0]))
    port = params_from_jax(jtree)
    save_params(str(tmp_path / "port.npz"), port)
    got = load_params(str(tmp_path / "port.npz"), dtype[1])
    _assert_same(got, want)
    _assert_same(got, port)
    if model == "dit":
        assert isinstance(got["blocks"], list) and len(got["blocks"]) == 2
    if mode is not None:
        kernel = got["blocks"][0]["attn_q"]["kernel"] if model == "dit" else \
            got["down_blocks"][0]["resnets"][0]["conv1"]["kernel"]
        assert kernel.mode == mode and kernel.channel_tile == tile


def _refusal(load, path, dtype):
    with pytest.raises(ValueError) as err:
        load(path, dtype)
    return str(err.value).replace(path, "<archive>")


def test_load_refusals_match_jax(jax_trees, tmp_path):
    """A quantized archive refuses an explicit dtype other than its own,
    and an archive of two compute dtypes refuses to load, in both
    packages alike."""
    jtree = _jax_quantized(jax_trees["unet"], "int8", 1)
    jp, pp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_weights.save_params(jp, jtree)
    save_params(pp, params_from_jax(jtree))
    assert (_refusal(load_params, pp, torch.bfloat16)
            == _refusal(jax_weights.load_params, jp, jnp.bfloat16))
    w = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    mixed = {"a": {"kernel": jax_quantize_weight(jnp.asarray(w), "int8")},
             "b": {"kernel": jax_quantize_weight(jnp.asarray(w, jnp.bfloat16), "int8")}}
    jax_weights.save_params(jp, mixed)
    save_params(pp, params_from_jax(mixed))
    assert (_refusal(load_params, pp, None)
            == _refusal(jax_weights.load_params, jp, None))


def _tiny_sdxl(unet_params, **fields):
    from distrifuser_tpu_torch import DistriConfig, DistriSDXLPipeline
    from distrifuser_tpu_torch.models import clip, vae

    gen = torch.Generator().manual_seed(9)
    tcfgs = [clip.tiny_clip_config(hidden=16),
             clip.CLIPTextConfig(vocab_size=1000, hidden_size=16, num_hidden_layers=2,
                                 num_attention_heads=4, intermediate_size=32,
                                 projection_dim=32)]
    cfg = DistriConfig(device="cpu", height=128, width=128, warmup_steps=1, batch_size=1,
                       **fields)
    return DistriSDXLPipeline.from_params(
        cfg, port_unet.tiny_config(cross_attention_dim=32, sdxl=True), unet_params,
        vae.tiny_vae_config(), vae.init_vae_params(gen, vae.tiny_vae_config()), tcfgs,
        [clip.init_clip_params(gen, c) for c in tcfgs])


def test_reloaded_int8_tree_serves_the_same_latents(jax_trees, tmp_path):
    """``DistriSDXLPipeline.from_params(cfg, unet_config, load_params(path),
    ...)`` with ``cfg.weight_quant`` the archive's mode: the reloaded
    pipeline gives the saved pipeline's latents, bit for bit."""
    dense = params_from_jax(jax_trees["unet"])
    saved = _tiny_sdxl(dense, weight_quant="int8")
    path = str(tmp_path / "unet.npz")
    save_params(path, saved.runner.params)
    reloaded = _tiny_sdxl(load_params(path), weight_quant="int8")
    latents = torch.from_numpy(np.random.RandomState(3).randn(1, 16, 16, 4).astype(np.float32))
    kw = dict(latents=latents, num_inference_steps=3, output_type="latent")
    want = saved("a lighthouse at dusk", **kw).images
    got = reloaded("a lighthouse at dusk", **kw).images
    assert isinstance(saved.runner.params["conv_in"]["kernel"], QuantizedTensor)
    assert torch.equal(torch.as_tensor(np.asarray(got)), torch.as_tensor(np.asarray(want)))
    # the archive holds no compute policy: the pipeline's re-tags the leaves
    assert quantize_params(load_params(path), "int8", compute="dot")["conv_in"][
        "kernel"].compute == "dot"
