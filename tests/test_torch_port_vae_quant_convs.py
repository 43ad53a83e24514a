"""PyTorch port: a VAE without the 1x1 quant convs (SD3's published VAE,
``use_quant_conv`` / ``use_post_quant_conv`` false in its config.json).

With the flags false the port's decode (whole and row-tiled) and encode
(the posterior's mean and a sample) equal, bit for bit in float32 on the
CPU, the same run of a VAE whose convs are 1x1 identities; the reader takes
the flags (true by default) without changing the fields a config compares
with the JAX package's; ``init_vae_params`` draws no conv the flags leave
out; and a snapshot written without the convs loads through the reader and
the converter and decodes.  With the flags true every VAE parity test
against the JAX package (test_torch_port_vae_sp.py, _img2img.py,
_snapshots.py, _sd_unet.py) holds the convs as before.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from distrifuser_tpu.models import vae as jax_vae
from distrifuser_tpu_torch.models import vae
from distrifuser_tpu_torch.models.weights import convert_vae_state_dict
from distrifuser_tpu_torch.native.safetensors import load_sharded_safetensors
from test_torch_port_ranks import jax_layout
from test_torch_port_snapshots import VAE_JSON, _sd

NO_CONVS = {"use_quant_conv": False, "use_post_quant_conv": False}


def _identity_convs(params, cfg):
    """``params`` with 1x1 identity quant convs added."""
    def eye(c):
        return {"kernel": torch.eye(c)[:, :, None, None], "bias": torch.zeros(c)}

    return {**params, "quant_conv": eye(2 * cfg.latent_channels),
            "post_quant_conv": eye(cfg.latent_channels)}


@pytest.fixture(scope="module")
def vaes():
    """(config without the convs, its tree; config with them, the same tree
    plus identity convs)."""
    cfg = vae.vae_config_from_json({**VAE_JSON, **NO_CONVS})
    params = vae.init_vae_params(torch.Generator().manual_seed(4), cfg)
    with_cfg = vae.vae_config_from_json(VAE_JSON)
    return cfg, params, with_cfg, _identity_convs(params, with_cfg)


def test_reader_takes_the_flags():
    assert not vae.vae_config_from_json({**VAE_JSON, **NO_CONVS}).use_quant_conv
    got = vae.vae_config_from_json({**VAE_JSON, "use_post_quant_conv": False})
    assert got.use_quant_conv and not got.use_post_quant_conv
    plain = vae.vae_config_from_json(VAE_JSON)
    assert plain.use_quant_conv and plain.use_post_quant_conv
    # the fields compare with the JAX reader's, which ignores the flags
    assert (dataclasses.asdict(vae.vae_config_from_json({**VAE_JSON, **NO_CONVS}))
            == dataclasses.asdict(jax_vae.vae_config_from_json({**VAE_JSON, **NO_CONVS})))


def test_init_leaves_the_convs_out(vaes):
    cfg, params, with_cfg, _ = vaes
    assert "quant_conv" not in params and "post_quant_conv" not in params
    full = vae.init_vae_params(torch.Generator().manual_seed(4), with_cfg)
    assert {"quant_conv", "post_quant_conv"} <= set(full)


@pytest.mark.parametrize("tile", [0, 8])
def test_decode_equals_identity_convs(vaes, tile):
    cfg, params, with_cfg, with_params = vaes
    lat = torch.from_numpy(np.random.RandomState(0).randn(1, 16, 16, 4).astype(np.float32))
    got = vae.decode(params, cfg, lat, tile=tile)
    want = vae.decode(with_params, with_cfg, lat, tile=tile)
    assert torch.equal(got, want)


@pytest.mark.parametrize("sample", [False, True])
def test_encode_equals_identity_convs(vaes, sample):
    cfg, params, with_cfg, with_params = vaes
    img = torch.from_numpy(np.random.RandomState(1).rand(1, 32, 32, 3).astype(np.float32))
    kw = (lambda: {"generator": torch.Generator().manual_seed(7)}) if sample else dict
    got = vae.encode(params, cfg, img * 2 - 1, **kw())
    want = vae.encode(with_params, with_cfg, img * 2 - 1, **kw())
    assert torch.equal(got, want)


def test_snapshot_without_convs_loads(tmp_path, vaes):
    """A vae/ directory whose config.json says the convs are absent and whose
    weights lack them loads as from_pretrained loads it, and decodes."""
    full = vae.init_vae_params(torch.Generator().manual_seed(1), vaes[2])
    sd = {k: v for k, v in _sd(jax_layout(full)).items() if "quant_conv" not in k}
    (tmp_path / "vae").mkdir()
    (tmp_path / "vae" / "config.json").write_text(json.dumps({**VAE_JSON, **NO_CONVS}))
    save_file(sd, str(tmp_path / "vae" / "diffusion_pytorch_model.safetensors"))
    cfg = vae.vae_config_from_json(str(tmp_path / "vae" / "config.json"))
    params = convert_vae_state_dict(load_sharded_safetensors(str(tmp_path / "vae")))
    assert "quant_conv" not in params and "post_quant_conv" not in params
    lat = torch.from_numpy(np.random.RandomState(2).randn(1, 16, 16, 4).astype(np.float32))
    image = vae.decode(params, cfg, lat)
    assert image.shape == (1, 32, 32, 3) and torch.isfinite(image).all()
    want = vae.decode(_identity_convs(params, cfg), vae.vae_config_from_json(VAE_JSON), lat)
    assert torch.equal(image, want)
