"""PyTorch port: ``from_pretrained`` of local diffusers snapshots against the
JAX package, and the pure-Python safetensors reader.

Snapshots are fabricated in a temporary directory from seeded JAX trees,
inverted to diffusers / transformers names and layouts
(tests/test_weights_roundtrip.py ``invert_tree``) and written with
``safetensors.numpy``, each component with its ``config.json``, plus CLIP
vocab files and a scheduler config:

* SD 1.5-style: SD-shaped tiny UNet with conv projections, quick-GeLU text
  encoder (with the I64 ``position_ids`` of older transformers files),
  epsilon prediction;
* SD 2.1-style: linear projections, GeLU text encoder, ``v_prediction``;
* SDXL-style: two text encoders, the second with a projection, and
  ``tokenizer_2`` padding with "!";
* a UNet split into two shards beside an ``fp16`` variant file.

The port's and the JAX package's ``from_pretrained`` on the same directory
give equal configs, a port tree equal bit for bit to ``params_from_jax`` of
the JAX tree, tokenizer ids that agree, and latents after 2 steps within
2e-4.  The reader equals the ``safetensors`` package on F32, F16 and BF16
files (BF16 written with ``safetensors.torch``: numpy has no bf16).

The JAX package reads the shards here through its own fallback, the
``safetensors`` package, not its native mmap reader: its ``from_pretrained``
unmaps the native mappings (``release_mappings``) right after converting,
and on the CPU a copy that ``jnp.array`` still has in flight then reads
unmapped memory in a native thread (a segmentation fault about one run in
five when several snapshots load in one process).  Both readers give the
same arrays.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file
from safetensors.torch import load_file as torch_load_file
from safetensors.torch import save_file as torch_save_file

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu import pipelines as jax_pipelines
from distrifuser_tpu.models import clip as jax_clip
from distrifuser_tpu.models import unet as jax_unet
from distrifuser_tpu.models import vae as jax_vae
from distrifuser_tpu.models import weights as jax_weights
from distrifuser_tpu.native.bpe import _bytes_to_unicode
from distrifuser_tpu_torch import DistriConfig, DistriSDPipeline, DistriSDXLPipeline
from distrifuser_tpu_torch.models import weights as port_weights
from distrifuser_tpu_torch.models.weights import params_from_jax
from distrifuser_tpu_torch.native import safetensors as port_st
from distrifuser_tpu_torch.native.bpe import CLIPTokenizer
from test_torch_port_sd_unet import SD_DOWN, SD_UP
from test_weights_roundtrip import invert_tree

TOL = 2e-4
PROMPT = "the colorful theater and a cat's hat"


@pytest.fixture(autouse=True)
def jax_reads_shards_with_safetensors(monkeypatch):
    """The JAX loader's fallback instead of its native mmap reader (see the
    module docstring)."""
    import distrifuser_tpu.native

    monkeypatch.setattr(distrifuser_tpu.native, "load_safetensors_fast", lambda path: None)


def write_vocab(d, pad=None):
    """A CLIP-format vocab: every byte symbol, its </w> form, a few ranked
    merges and the special tokens; ``pad`` names a pad token."""
    d.mkdir(parents=True, exist_ok=True)
    chars = list(_bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    vocab.update({c + "</w>": len(chars) + i for i, c in enumerate(chars)})
    merges = [("t", "h"), ("th", "e</w>"), ("a", "n"), ("an", "d</w>"), ("c", "o"),
              ("co", "l"), ("o", "r"), ("col", "or"), ("a", "t</w>"), ("'", "s</w>"),
              ("h", "at</w>")]
    for l, r in merges:
        vocab.setdefault(l + r, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{l} {r}" for l, r in merges) + "\n",
        encoding="utf-8")
    if pad is not None:
        (d / "special_tokens_map.json").write_text(json.dumps({"pad_token": pad}))
    return vocab


def _sd(tree):
    sd = {}
    invert_tree(tree, "", sd)
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def clip_state_dict(tree, position_ids=True):
    """A JAX CLIP tree under transformers' CLIPTextModel names."""
    sd = {"text_model.embeddings.token_embedding.weight": np.asarray(tree["token_embedding"]),
          "text_model.embeddings.position_embedding.weight":
              np.asarray(tree["position_embedding"])}
    if position_ids:
        sd["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
    invert_tree(tree["layers"], "text_model.encoder.layers", sd)
    invert_tree(tree["final_layer_norm"], "text_model.final_layer_norm", sd)
    if "text_projection" in tree:
        invert_tree(tree["text_projection"], "text_projection", sd)
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def _component(root, name, cfg_json, sd, fname="diffusion_pytorch_model.safetensors"):
    (root / name).mkdir(parents=True, exist_ok=True)
    (root / name / "config.json").write_text(json.dumps(cfg_json))
    save_file(sd, str(root / name / fname))


def _text_json(vocab, hidden, act, projection=None):
    cfg = {"vocab_size": 1000, "hidden_size": hidden, "num_hidden_layers": 2,
           "num_attention_heads": 4, "intermediate_size": 2 * hidden,
           "max_position_embeddings": 77, "hidden_act": act,
           "eos_token_id": vocab["<|endoftext|>"], "architectures": ["CLIPTextModel"]}
    if projection:
        cfg.update(projection_dim=projection,
                   architectures=["CLIPTextModelWithProjection"])
    return cfg


VAE_JSON = {"block_out_channels": [16, 32], "in_channels": 3, "latent_channels": 4,
            "layers_per_block": 1, "norm_num_groups": 8, "out_channels": 3,
            "scaling_factor": 0.18215}
UNET_JSON = {
    "sd15": {"block_out_channels": [32, 32, 64, 64], "down_block_types": list(SD_DOWN),
             "up_block_types": list(SD_UP), "attention_head_dim": 2, "layers_per_block": 1,
             "norm_num_groups": 8, "cross_attention_dim": 32},
    "sd21": {"block_out_channels": [32, 32, 64, 64], "down_block_types": list(SD_DOWN),
             "up_block_types": list(SD_UP), "attention_head_dim": [2, 2, 4, 4],
             "layers_per_block": 1, "norm_num_groups": 8, "cross_attention_dim": 32,
             "use_linear_projection": True},
    "sdxl": {"block_out_channels": [32, 64], "down_block_types": ["DownBlock2D",
                                                                   "CrossAttnDownBlock2D"],
             "up_block_types": ["CrossAttnUpBlock2D", "UpBlock2D"],
             "attention_head_dim": [2, 4], "layers_per_block": 1, "norm_num_groups": 8,
             "cross_attention_dim": 32, "use_linear_projection": True,
             "transformer_layers_per_block": 1, "addition_embed_type": "text_time",
             "addition_time_embed_dim": 8, "projection_class_embeddings_input_dim": 80},
}


def make_snapshot(root, kind, sharded=False):
    """Fabricate a snapshot of ``kind`` ("sd15", "sd21", "sdxl") under
    ``root``; ``sharded`` splits the UNet into two shards and adds an fp16
    variant file with other values.  Returns ``root`` as a string."""
    ucfg = jax_unet.unet_config_from_json(UNET_JSON[kind])
    unet_sd = _sd(jax_unet.init_unet_params(jax.random.PRNGKey(0), ucfg))
    (root / "unet").mkdir(parents=True, exist_ok=True)
    (root / "unet" / "config.json").write_text(json.dumps(UNET_JSON[kind]))
    if sharded:
        names = sorted(unet_sd)
        half = len(names) // 2
        for i, part in enumerate((names[:half], names[half:])):
            save_file({k: unet_sd[k] for k in part},
                      str(root / "unet" / f"diffusion_pytorch_model-0000{i + 1}-of-00002"
                                          ".safetensors"))
        save_file({k: (v * 0.5).astype(np.float16) for k, v in unet_sd.items()},
                  str(root / "unet" / "diffusion_pytorch_model.fp16.safetensors"))
    else:
        save_file(unet_sd, str(root / "unet" / "diffusion_pytorch_model.safetensors"))
    vcfg = jax_vae.vae_config_from_json(VAE_JSON)
    _component(root, "vae", VAE_JSON,
               _sd(jax_vae.init_vae_params(jax.random.PRNGKey(1), vcfg)))
    vocab = write_vocab(root / "tokenizer")
    encoders = [("text_encoder", 32 if kind != "sdxl" else 16,
                 "gelu" if kind == "sd21" else "quick_gelu", None)]
    if kind == "sdxl":
        write_vocab(root / "tokenizer_2", pad="!")
        encoders.append(("text_encoder_2", 16, "gelu", 32))
    for i, (name, hidden, act, proj) in enumerate(encoders):
        cfg_json = _text_json(vocab, hidden, act, proj)
        tcfg = jax_clip.clip_config_from_json(cfg_json)
        tree = jax_clip.init_clip_params(jax.random.PRNGKey(2 + i), tcfg)
        _component(root, name, cfg_json, clip_state_dict(tree), "model.safetensors")
    (root / "scheduler").mkdir()
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        {"prediction_type": "v_prediction" if kind == "sd21" else "epsilon",
         "num_train_timesteps": 1000, "beta_schedule": "scaled_linear"}))
    return str(root)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{path}/{i}").items()}
    return {path: tree}


def assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        # the same memory layout (a stride of a size-1 dim is arbitrary)
        assert [s for s, n in zip(got[k].stride(), got[k].shape) if n > 1] == \
            [s for s, n in zip(want[k].stride(), want[k].shape) if n > 1], k
        assert torch.equal(got[k], want[k]), k


KINDS = {"sd15": (DistriSDPipeline, jax_pipelines.DistriSDPipeline),
         "sd21": (DistriSDPipeline, jax_pipelines.DistriSDPipeline),
         "sdxl": (DistriSDXLPipeline, jax_pipelines.DistriSDXLPipeline)}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_from_pretrained_matches_jax(kind, tmp_path, devices8):
    root = make_snapshot(tmp_path / kind, kind)
    port_cls, jax_cls = KINDS[kind]
    jpipe = jax_cls.from_pretrained(
        JaxDistriConfig(devices=devices8[:1], height=128, width=128), root)
    ppipe = port_cls.from_pretrained(DistriConfig(device="cpu", height=128, width=128),
                                     root)
    assert dataclasses.asdict(ppipe.unet_config) == dataclasses.asdict(jpipe.unet_config)
    assert dataclasses.asdict(ppipe.vae_config) == dataclasses.asdict(jpipe.vae_config)
    assert ([dataclasses.asdict(c) for c, _ in ppipe.text_encoders]
            == [dataclasses.asdict(c) for c, _ in jpipe.text_encoders])
    assert ppipe.scheduler.prediction_type == jpipe.scheduler.prediction_type
    assert ppipe.scheduler.prediction_type == ("v_prediction" if kind == "sd21"
                                                else "epsilon")
    assert ppipe.unet_config.use_linear_projection is (kind != "sd15")
    conv = lambda t: params_from_jax(jax.device_get(t))  # noqa: E731
    assert_trees_equal(ppipe.runner.params, conv(jpipe.runner.params))
    assert_trees_equal(ppipe.vae_params, conv(jpipe.vae_params))
    for (_, got), (_, want) in zip(ppipe.text_encoders, jpipe.text_encoders):
        assert_trees_equal(got, conv(want))
    for ptok, jtok in zip(ppipe.tokenizers, jpipe.tokenizers):
        assert isinstance(ptok, CLIPTokenizer)
        assert ptok.pad_token_id == jtok.pad_token_id
        np.testing.assert_array_equal(
            ptok([PROMPT, ""])["input_ids"], jtok([PROMPT, ""])["input_ids"])
    latents = np.random.RandomState(7).randn(1, 16, 16, 4).astype(np.float32)
    kw = dict(num_inference_steps=2, output_type="latent")
    want = np.asarray(jpipe(PROMPT, latents=latents, **kw).images[0])
    got = ppipe(PROMPT, latents=latents, **kw).images[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("variant", [None, "fp16"])
def test_sharded_and_variant_unet_matches_jax(variant, tmp_path):
    """Two base shards beside an fp16 file: without a variant the shards
    load (the variant is skipped), with "fp16" only the fp16 file does;
    the port's converted tree equals params_from_jax of the JAX one."""
    root = make_snapshot(tmp_path / "sharded", "sd15", sharded=True)
    want = jax_weights.convert_unet_state_dict(
        jax_weights.load_sharded_safetensors(f"{root}/unet", variant=variant))
    got = port_weights.convert_unet_state_dict(
        port_st.load_sharded_safetensors(f"{root}/unet", variant=variant))
    assert_trees_equal(got, params_from_jax(jax.device_get(want)))
    whole = port_weights.convert_unet_state_dict(
        port_st.load_sharded_safetensors(f"{root}/unet"))
    scale = 0.5 if variant else 1.0
    torch.testing.assert_close(got["conv_in"]["kernel"], whole["conv_in"]["kernel"] * scale,
                               rtol=1e-3, atol=1e-3)
    with pytest.raises(FileNotFoundError, match="bf16"):
        port_st.load_sharded_safetensors(f"{root}/unet", variant="bf16")


@pytest.mark.parametrize("which", ["vae", "clip"])
def test_converters_match_jax_bf16(which, tmp_path):
    """The VAE and CLIP converters cast to bf16 as the JAX ones do."""
    if which == "vae":
        tree = jax_vae.init_vae_params(jax.random.PRNGKey(1), jax_vae.tiny_vae_config())
        sd, jconv, pconv = _sd(tree), jax_weights.convert_vae_state_dict, \
            port_weights.convert_vae_state_dict
    else:
        tree = jax_clip.init_clip_params(jax.random.PRNGKey(2), jax_clip.tiny_clip_config())
        sd, jconv, pconv = clip_state_dict(tree, position_ids=False), \
            jax_weights.convert_clip_state_dict, port_weights.convert_clip_state_dict
    import jax.numpy as jnp

    want = params_from_jax(jax.device_get(jconv(sd, jnp.bfloat16)))
    got = pconv({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, torch.bfloat16)
    assert_trees_equal(got, want)


def test_reader_matches_safetensors_package(tmp_path):
    r = np.random.RandomState(0)
    arrays = {"a.weight": r.randn(3, 5).astype(np.float32),
              "b.weight": r.randn(7).astype(np.float16),
              "c.scalar": np.array(2.5, np.float32),
              "d.empty": np.zeros((0, 4), np.float32),
              "e.conv": r.randn(4, 2, 3, 3).astype(np.float16)}
    save_file(arrays, str(tmp_path / "np.safetensors"), metadata={"format": "pt"})
    bf16 = {"x": torch.randn(5, 3, dtype=torch.bfloat16),
            "y": torch.randn(2, 2, 2, 2).to(torch.bfloat16), "z": torch.randn(9)}
    torch_save_file(bf16, str(tmp_path / "bf16.safetensors"))
    for name in ("np.safetensors", "bf16.safetensors"):
        want = torch_load_file(str(tmp_path / name))
        got = port_st.load_safetensors(str(tmp_path / name))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            assert torch.equal(got[k], want[k]), k


def test_reader_refuses_other_dtypes_unless_skipped(tmp_path):
    save_file({"w": np.ones((2, 2), np.float32), "ids.position_ids": np.arange(3)},
              str(tmp_path / "m.safetensors"))
    with pytest.raises(ValueError, match="I64"):
        port_st.load_safetensors(str(tmp_path / "m.safetensors"))
    got = port_st.load_safetensors(str(tmp_path / "m.safetensors"), skip=("position_ids",))
    assert list(got) == ["w"]


def test_from_pretrained_refuses_missing_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match="local model directory"):
        DistriSDPipeline.from_pretrained(DistriConfig(device="cpu"), str(tmp_path / "nope"))


def test_missing_tokenizer_falls_back_loudly(tmp_path, capsys):
    from distrifuser_tpu_torch.pipelines import SimpleTokenizer, _tokenizer_or_fallback

    tok = _tokenizer_or_fallback(str(tmp_path / "tokenizer"))
    assert isinstance(tok, SimpleTokenizer)
    assert "WARNING: failed to load CLIP tokenizer" in capsys.readouterr().err
