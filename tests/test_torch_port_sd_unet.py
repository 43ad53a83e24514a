"""PyTorch port: the SD 1.x / 2.x UNet and the model configs against the JAX
package.

Tiny UNets with the SD block structure (four levels, cross-attention in the
first three, a plain last level, no added conditioning): SD 1.5's layout
with conv projections in and out of each transformer
(``use_linear_projection=False``, the path no tiny SDXL config reaches),
and SD 2.1's with linear ones.  The same JAX tree (through
``params_from_jax``) and numpy inputs go through both ``unet_forward``s in
float32 on the CPU, within the whole-UNet tolerance 5e-4.  The presets
(SD 1.5, SD 2.1, the SD VAE, OpenCLIP ViT-H) and the ``config.json``
readers give the JAX package's configs field for field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrifuser_tpu.models import clip as jax_clip
from distrifuser_tpu.models import unet as jax_unet
from distrifuser_tpu.models import vae as jax_vae
from distrifuser_tpu_torch.models import clip as port_clip
from distrifuser_tpu_torch.models import unet as port_unet
from distrifuser_tpu_torch.models import vae as port_vae
from distrifuser_tpu_torch.models.weights import params_from_jax

TOL = 5e-4
SD_DOWN = ("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",)
SD_UP = ("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3


def tiny_sd_config(mod, linear_projection: bool):
    """SD-shaped tiny UNet: SD 1.5's layout (conv projections, one head
    width at every level) or SD 2.1's (linear projections, heads growing
    with the width)."""
    return mod.UNetConfig(
        block_out_channels=(32, 32, 64, 64), down_block_types=SD_DOWN,
        up_block_types=SD_UP, layers_per_block=1,
        transformer_layers_per_block=(1, 1, 1, 1),
        num_attention_heads=(2, 2, 4, 4) if linear_projection else (2, 2, 2, 2),
        cross_attention_dim=32, norm_num_groups=8,
        use_linear_projection=linear_projection, addition_embed_type=None,
        projection_class_embeddings_input_dim=0)


@pytest.mark.parametrize("linear_projection", [False, True], ids=["sd15_conv_proj",
                                                                  "sd21_linear_proj"])
@pytest.mark.parametrize("text_kv", [False, True], ids=["inline_kv", "cached_kv"])
def test_sd_unet_forward_matches_jax(linear_projection, text_kv):
    jcfg = tiny_sd_config(jax_unet, linear_projection)
    jparams = jax_unet.init_unet_params(jax.random.PRNGKey(0), jcfg)
    if not linear_projection:  # 1x1 conv projections: 4-D kernels
        assert jparams["down_blocks"][0]["attentions"][0]["proj_in"]["kernel"].ndim == 4
    r = np.random.RandomState(0)
    sample = r.randn(2, 16, 16, 4).astype(np.float32)
    enc = r.randn(2, 8, 32).astype(np.float32)
    t = np.array([981, 501], np.int64)
    want = jax_unet.unet_forward(jparams, jcfg, jnp.asarray(sample), jnp.asarray(t),
                                 jnp.asarray(enc))
    pcfg = tiny_sd_config(port_unet, linear_projection)
    pparams = params_from_jax(jax.device_get(jparams))
    penc = torch.from_numpy(enc)
    dispatch = port_unet.DenseDispatch(
        text_kv=port_unet.precompute_text_kv(pparams, penc) if text_kv else None)
    got = port_unet.unet_forward(pparams, pcfg, torch.from_numpy(sample),
                                 torch.from_numpy(t), penc, dispatch=dispatch)
    assert tuple(got.shape) == want.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["sd15_config", "sd21_config", "sdxl_config"])
def test_unet_presets_match_jax(name):
    assert (dataclasses.asdict(getattr(port_unet, name)())
            == dataclasses.asdict(getattr(jax_unet, name)()))


@pytest.mark.parametrize("mod_name,name", [
    ("vae", "sd_vae_config"), ("vae", "sdxl_vae_config"),
    ("clip", "open_clip_vith_config"), ("clip", "clip_vit_l_config"),
    ("clip", "open_clip_bigg_config")])
def test_aux_presets_match_jax(mod_name, name):
    jmod, pmod = {"vae": (jax_vae, port_vae), "clip": (jax_clip, port_clip)}[mod_name]
    assert dataclasses.asdict(getattr(pmod, name)()) == dataclasses.asdict(
        getattr(jmod, name)())


def test_sd15_head_dims_and_attention_calls():
    """SD 1.5's 8 heads give d = 40, 80, 160; 16 transformer blocks, so 32
    flash calls per UNet evaluation."""
    cfg = port_unet.sd15_config()
    dims = [c // h for c, h in zip(cfg.block_out_channels, cfg.num_attention_heads)]
    assert dims == [40, 80, 160, 160]
    assert port_unet.transformer_blocks_per_level(cfg) == [5, 5, 5, 1]
    assert port_unet.attention_calls_per_forward(cfg) == 32


UNET_JSONS = {
    "sd15": {"block_out_channels": [320, 640, 1280, 1280], "down_block_types": list(SD_DOWN),
             "up_block_types": list(SD_UP), "attention_head_dim": 8,
             "cross_attention_dim": 768, "layers_per_block": 2},
    "sd21": {"block_out_channels": [320, 640, 1280, 1280], "down_block_types": list(SD_DOWN),
             "up_block_types": list(SD_UP), "attention_head_dim": [5, 10, 20, 20],
             "cross_attention_dim": 1024, "use_linear_projection": True,
             "dual_cross_attention": [False] * 4, "only_cross_attention": False},
    "sdxl": {"block_out_channels": [320, 640, 1280],
             "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D",
                                  "CrossAttnDownBlock2D"],
             "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"],
             "attention_head_dim": [5, 10, 20], "transformer_layers_per_block": [1, 2, 10],
             "cross_attention_dim": 2048, "use_linear_projection": True,
             "addition_embed_type": "text_time", "addition_time_embed_dim": 256,
             "projection_class_embeddings_input_dim": 2816},
    "num_heads_key": {"block_out_channels": [32, 64], "num_attention_heads": [2, 4],
                      "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D"],
                      "up_block_types": ["CrossAttnUpBlock2D", "UpBlock2D"],
                      "cross_attention_dim": [32, 32]},
}


@pytest.mark.parametrize("name", sorted(UNET_JSONS))
def test_unet_config_from_json_matches_jax(name, tmp_path):
    path = tmp_path / "config.json"
    path.write_text(__import__("json").dumps(UNET_JSONS[name]))
    for source in (UNET_JSONS[name], str(path)):
        assert (dataclasses.asdict(port_unet.unet_config_from_json(source))
                == dataclasses.asdict(jax_unet.unet_config_from_json(source)))
    if name == "sd15":
        assert port_unet.unet_config_from_json(path) == port_unet.sd15_config()


@pytest.mark.parametrize("bad", [
    {"class_embed_type": "timestep"}, {"only_cross_attention": [True] * 4},
    {"mid_block_type": None}, {"addition_embed_type": "text"},
    {"cross_attention_dim": [768, 1024, 768, 768]}])
def test_unet_config_from_json_refusals_match_jax(bad):
    cfg = {**UNET_JSONS["sd15"], **bad}
    with pytest.raises(NotImplementedError):
        jax_unet.unet_config_from_json(cfg)
    with pytest.raises(NotImplementedError):
        port_unet.unet_config_from_json(cfg)


@pytest.mark.parametrize("cfg", [
    {"scaling_factor": 0.18215}, {"scaling_factor": 0.13025, "shift_factor": None},
    {"block_out_channels": [16, 32], "layers_per_block": 1, "norm_num_groups": 8}])
def test_vae_config_from_json_matches_jax(cfg):
    assert (dataclasses.asdict(port_vae.vae_config_from_json(cfg))
            == dataclasses.asdict(jax_vae.vae_config_from_json(cfg)))


@pytest.mark.parametrize("cfg", [
    {"hidden_size": 1024, "num_hidden_layers": 23, "num_attention_heads": 16,
     "intermediate_size": 4096, "hidden_act": "gelu", "projection_dim": 512,
     "architectures": ["CLIPTextModel"]},
    {"hidden_size": 1280, "num_hidden_layers": 32, "num_attention_heads": 20,
     "intermediate_size": 5120, "hidden_act": "gelu", "projection_dim": 1280,
     "architectures": ["CLIPTextModelWithProjection"]},
    {}])
def test_clip_config_from_json_matches_jax(cfg):
    assert (dataclasses.asdict(port_clip.clip_config_from_json(cfg))
            == dataclasses.asdict(jax_clip.clip_config_from_json(cfg)))
