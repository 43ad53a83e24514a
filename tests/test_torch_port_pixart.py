"""PyTorch port: PixArt-α (the DiT, T5 and DistriPixArtPipeline) against
the JAX package.

The same inputs, made from numpy seeds, go through the JAX function and its
counterpart in the port, on the CPU in float32, at the tiny sizes
(``tiny_dit_config(depth=2)``, ``tiny_t5_config()``, a 16x16 latent):

* each DiT and T5 module (``patchify`` / ``unpatchify``, ``pos_embed_table``
  at both interpolation settings, ``t_embed``, ``fold_size_condition``,
  ``caption_mask_bias``, ``dit_block`` dense, cache, kv_assemble and
  attn_core, the bucketing) within rtol 1e-4 / atol 1e-5, ``dit_forward``
  and ``t5_encode`` gated and plain within 5e-4 of the largest value;
* ``convert_pixart_state_dict`` and ``convert_t5_state_dict`` on synthetic
  diffusers / transformers state dicts: the JAX converter's tree, carried
  across by ``params_from_jax`` (which unstacks its blocks), equals the
  port's leaf for leaf;
* ``DistriPixArtPipeline`` with T5 weights, CFG on, DDIM and DPM-solver,
  to latents within 5e-4 of the JAX pipeline on the same weights and
  noise; int8 under ``quant_compute="pallas"`` from the same payloads and
  scales (within the quantized pipelines' limits, and 2e-4 densified);
* ``from_pretrained`` over a snapshot directory the test writes
  (safetensors shards, config.json files, a tokenizer.json) gives the JAX
  ``from_pretrained``'s latent on it, the port reading the tokenizer with
  native/unigram.py where the JAX package uses transformers;
* the Unigram reader against transformers' tokenizer on synthetic
  tokenizer.json files (a SentencePiece precompiled character map, NFKC,
  both pre-tokenizer forms); the hash fallback id for id.
"""

import base64
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu import pipelines as jax_pipelines
from distrifuser_tpu.models import dit as jax_dit
from distrifuser_tpu.models import t5 as jax_t5
from distrifuser_tpu.models import vae as jax_vae
from distrifuser_tpu.models import weights as jax_weights
from distrifuser_tpu_torch import DistriConfig
from distrifuser_tpu_torch import pipelines as port_pipelines
from distrifuser_tpu_torch.models import dit as port_dit
from distrifuser_tpu_torch.models import t5 as port_t5
from distrifuser_tpu_torch.models import vae as port_vae
from distrifuser_tpu_torch.models import weights as port_weights
from distrifuser_tpu_torch.models.weights import params_from_jax
from distrifuser_tpu_torch.native.unigram import UnigramTokenizer
from distrifuser_tpu_torch.parallel.compress import QuantizedTensor
from test_pixart import PIXART_JSON, synthetic_pixart_sd
from test_torch_port_quant_pipeline import PIPE_MAX, PIPE_REL_L2
from test_torch_port_ranks import jax_layout
from test_torch_port_sd_quant import _quantized_leaves
from test_torch_port_snapshots import jax_reads_shards_with_safetensors  # noqa: F401
from test_weights_roundtrip import invert_tree

RTOL, ATOL = 1e-4, 1e-5
TOL = 5e-4  # whole model and pipeline: max |d| / max |ref|
PROMPTS = ["a photo of the cat", "an abc photo"]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= tol, err


def _op_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def jax_tree(tree):
    """A port tree as the JAX package holds it (``jax_layout``), the DiT's
    blocks and T5's layers stacked on a leading axis: seeding with the
    port's init is much cheaper than the JAX package's op-by-op init."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("blocks", "layers") and isinstance(v, list):
                out[k] = jax.tree.map(lambda *ls: np.stack(ls), *jax_layout(v))
            else:
                out[k] = jax_tree(v)
        return out
    return jax_layout(tree)


def _seeded(init, cfg, seed):
    tree = jax_tree(init(torch.Generator().manual_seed(seed), cfg))
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree)


@pytest.fixture(scope="module")
def dit():
    """(JAX config, JAX params, port config, port params) of the tiny DiT."""
    pcfg = port_dit.tiny_dit_config(depth=2)
    jp, pp = _seeded(port_dit.init_dit_params, pcfg, 0)
    return jax_dit.tiny_dit_config(depth=2), jp, pcfg, pp


@pytest.fixture(scope="module")
def t5():
    """{gated: (JAX config, JAX params, port config, port params)}."""
    out = {}
    for gated in (True, False):
        pcfg = port_t5.tiny_t5_config(gated=gated)
        jp, pp = _seeded(port_t5.init_t5_params, pcfg, 1 + gated)
        out[gated] = (jax_t5.tiny_t5_config(gated=gated), jp, pcfg, pp)
    return out


# -- the DiT's modules --------------------------------------------------------


def test_patchify_unpatchify_match_jax(dit):
    jcfg, _, pcfg, _ = dit
    x = np.random.RandomState(0).randn(2, 16, 16, 4).astype(np.float32)
    tokens = jax_dit.patchify(jcfg, jnp.asarray(x))
    got = port_dit.patchify(pcfg, _t(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(tokens))
    np.testing.assert_array_equal(port_dit.unpatchify(pcfg, got, 4).numpy(), x)


@pytest.mark.parametrize("fields", [{}, {"interpolation_scale": 2.0, "pos_embed_base_size": 4}],
                         ids=["native", "interpolated"])
def test_pos_embed_table_matches_jax(fields):
    kw = dict(sample_size=16, hidden_size=64, depth=1, num_heads=4, caption_dim=32, **fields)
    want = jax_dit.pos_embed_table(jax_dit.DiTConfig(**kw))
    _op_close(port_dit.pos_embed_table(port_dit.DiTConfig(**kw)), want)


def test_t_embed_and_adaln_match_jax(dit):
    jcfg, jp, pcfg, pp = dit
    for t in (0.0, 999.0, 417.0):
        temb = jax_dit.t_embed(jp, jcfg, jnp.float32(t))
        got = port_dit.t_embed(pp, pcfg, torch.tensor(t))
        _op_close(got, temb)
        _op_close(port_dit.adaln_table(pp, pcfg, got), jax_dit.adaln_table(jp, jcfg, temb))


def test_fold_size_condition_matches_jax():
    kw = dict(sample_size=16, hidden_size=48, depth=1, num_heads=4, caption_dim=32,
              use_additional_conditions=True)
    jcfg = jax_dit.DiTConfig(**kw)
    jp, pp = _seeded(port_dit.init_dit_params, port_dit.DiTConfig(**kw), 3)
    want = jax_dit.fold_size_condition(jp, jcfg, 1024.0, 768.0)["t_fc2"]["bias"]
    got = port_dit.fold_size_condition(pp, port_dit.DiTConfig(**kw), 1024.0, 768.0)
    _op_close(got["t_fc2"]["bias"], want)
    assert not torch.equal(got["t_fc2"]["bias"], pp["t_fc2"]["bias"])
    # no additional conditions: the tree is returned untouched
    plain = port_dit.DiTConfig(**{**kw, "use_additional_conditions": False})
    assert port_dit.fold_size_condition(pp, plain, 1024.0, 768.0) is pp


def test_caption_mask_bias_matches_jax():
    mask = np.float32([[1, 1, 0, 0], [1, 0, 1, 0]])
    np.testing.assert_array_equal(port_dit.caption_mask_bias(_t(mask)).numpy(),
                                  np.asarray(jax_dit.caption_mask_bias(jnp.asarray(mask))))


@pytest.mark.parametrize("mode", ["dense", "cache", "kv_assemble", "attn_core"])
def test_dit_block_modes_match_jax(dit, mode):
    """Each mode of ``dit_block`` against the JAX one, with the caption
    mask: the cache overwrites rows 4.. of a full KV, kv_assemble appends a
    fixed KV block, attn_core replaces the attention by the block's own
    sdpa over the KV reversed."""
    jcfg, jp, pcfg, pp = dit
    rs = np.random.RandomState(4)
    h, lq = jcfg.hidden_size, 8
    x = rs.randn(2, lq, h).astype(np.float32)
    c6 = rs.randn(6, h).astype(np.float32) * 0.1
    cap_kv = rs.randn(2, 5, 2 * h).astype(np.float32)
    mask = np.float32([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]])
    full = rs.randn(2, 20, 2 * h).astype(np.float32)
    extra = rs.randn(2, 3, 2 * h).astype(np.float32)
    jbp = jax.tree.map(lambda a: a[1], jp["blocks"])
    jkw, pkw = {}, {}
    if mode == "cache":
        jkw = dict(self_kv=(jnp.asarray(full[..., :h]), jnp.asarray(full[..., h:])),
                   patch_start=4)
        pkw = dict(self_kv=_t(full), patch_start=4)
    elif mode == "kv_assemble":
        jkw["kv_assemble"] = lambda k, v: (
            jnp.concatenate([k, jnp.asarray(extra[..., :h])], 1),
            jnp.concatenate([v, jnp.asarray(extra[..., h:])], 1))
        pkw["kv_assemble"] = lambda kv: torch.cat([kv, _t(extra)], 1)
    elif mode == "attn_core":
        from distrifuser_tpu.ops.attention import sdpa as jax_sdpa
        from distrifuser_tpu_torch.ops.attention import sdpa, split_kv

        jkw["attn_core"] = lambda q, k, v: jax_sdpa(q, k[:, ::-1], v[:, ::-1] * 2,
                                                    heads=jcfg.num_heads)

        def core(q, kv):
            k, v = split_kv(kv.flip(1))
            return sdpa(q, k, v * 2, heads=pcfg.num_heads)
        pkw["attn_core"] = core
    want, (k, v) = jax_dit.dit_block(jbp, jcfg, jnp.asarray(x), jnp.asarray(c6),
                                     jnp.asarray(cap_kv),
                                     cap_bias=jax_dit.caption_mask_bias(jnp.asarray(mask)),
                                     **jkw)
    got, kv = port_dit.dit_block(pp["blocks"][1], pcfg, _t(x), _t(c6), _t(cap_kv),
                                 cap_bias=port_dit.caption_mask_bias(_t(mask)), **pkw)
    _op_close(got, want)
    _op_close(kv, np.concatenate([np.asarray(k), np.asarray(v)], -1))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_dit_forward_matches_jax(dit, masked):
    jcfg, jp, pcfg, pp = dit
    rs = np.random.RandomState(5)
    x = rs.randn(2, 16, 16, 4).astype(np.float32)
    enc = rs.randn(2, 7, 32).astype(np.float32)
    mask = np.ones((2, 7), np.float32)
    mask[1, 3:] = 0
    m = (jnp.asarray(mask), _t(mask)) if masked else (None, None)
    want = jax_dit.dit_forward(jp, jcfg, jnp.asarray(x), jnp.float32(601.0),
                               jnp.asarray(enc), cap_mask=m[0])
    got = port_dit.dit_forward(pp, pcfg, _t(x), torch.tensor(601.0), _t(enc), cap_mask=m[1])
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 4)
    _close(got, want)


# -- T5 ---------------------------------------------------------------------


@pytest.mark.parametrize("gated", [True, False], ids=["gated_gelu", "relu"])
def test_t5_encode_matches_jax(t5, gated):
    jcfg, jp, pcfg, pp = t5[gated]
    rs = np.random.RandomState(6)
    ids = rs.randint(0, 140, (2, 11))  # ids past the vocab clamp in both
    mask = np.ones((2, 11), np.int64)
    mask[0, 7:] = 0
    for m in (None, mask):
        want = jax_t5.t5_encode(jp, jcfg, jnp.asarray(ids),
                                None if m is None else jnp.asarray(m))
        got = port_t5.t5_encode(pp, pcfg, torch.from_numpy(ids),
                                None if m is None else torch.from_numpy(m))
        _close(got, want)


def test_relative_position_buckets_match_jax():
    for cfg in (jax_t5.tiny_t5_config(), jax_t5.t5_v1_1_xxl_config()):
        pcfg = port_t5.T5Config(**{f: getattr(cfg, f) for f in (
            "relative_attention_num_buckets", "relative_attention_max_distance")})
        np.testing.assert_array_equal(port_t5.relative_position_buckets(pcfg, 300).numpy(),
                                      np.asarray(jax_t5.relative_position_buckets(cfg, 300)))


def test_config_readers_match_jax():
    t5_json = {"d_model": 32, "d_kv": 8, "d_ff": 48, "num_layers": 3, "num_heads": 4,
               "vocab_size": 128, "feed_forward_proj": "gated-gelu"}
    assert (dataclass_dict(port_t5.t5_config_from_json(t5_json))
            == dataclass_dict(jax_t5.t5_config_from_json(t5_json)))
    assert (dataclass_dict(port_dit.dit_config_from_json(PIXART_JSON))
            == dataclass_dict(jax_dit.dit_config_from_json(PIXART_JSON)))
    assert dataclass_dict(port_dit.pixart_config()) == dataclass_dict(jax_dit.pixart_config())
    assert port_dit.pixart_config().head_dim == 72


def dataclass_dict(cfg):
    import dataclasses

    return dataclasses.asdict(cfg)


# -- the converters -----------------------------------------------------------


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}.{i}")
    else:
        assert got.shape == want.shape and torch.equal(got, want), path


def t5_state_dict(tree):
    """A JAX T5 tree under transformers' T5EncoderModel names."""
    sd = {"shared.weight": np.asarray(tree["shared"]),
          "encoder.final_layer_norm.weight": np.asarray(tree["final_norm"]),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
              np.asarray(tree["relative_attention_bias"])}
    layers = tree["layers"]
    for i in range(np.shape(layers["attn_norm"])[0]):
        a, f = f"encoder.block.{i}.layer.0", f"encoder.block.{i}.layer.1"
        for n in "qkvo":
            sd[f"{a}.SelfAttention.{n}.weight"] = np.asarray(layers["attn"][n]["kernel"][i]).T
        sd[f"{a}.layer_norm.weight"] = np.asarray(layers["attn_norm"][i])
        for n, leaf in layers["ff"].items():
            sd[f"{f}.DenseReluDense.{n}.weight"] = np.asarray(leaf["kernel"][i]).T
        sd[f"{f}.layer_norm.weight"] = np.asarray(layers["ff_norm"][i])
    return {k: np.ascontiguousarray(v) for k, v in sd.items()}


def test_convert_pixart_state_dict_matches_jax():
    sd = synthetic_pixart_sd(seed=7)
    for name in ("resolution_embedder", "aspect_ratio_embedder"):
        r = np.random.RandomState(len(name))
        sd[f"adaln_single.emb.{name}.linear_1.weight"] = r.randn(21, 256).astype(np.float32)
        sd[f"adaln_single.emb.{name}.linear_1.bias"] = r.randn(21).astype(np.float32)
        sd[f"adaln_single.emb.{name}.linear_2.weight"] = r.randn(21, 21).astype(np.float32)
        sd[f"adaln_single.emb.{name}.linear_2.bias"] = r.randn(21).astype(np.float32)
    want = params_from_jax(jax.device_get(jax_weights.convert_pixart_state_dict(sd)))
    got = port_weights.convert_pixart_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    _assert_trees_equal(got, want)
    assert len(got["blocks"]) == 2 and got["final_out"]["kernel"].shape == (64, 16)


def test_convert_t5_state_dict_matches_jax(t5):
    for gated in (True, False):
        sd = t5_state_dict(jax.device_get(t5[gated][1]))
        want = params_from_jax(jax.device_get(jax_weights.convert_t5_state_dict(sd)))
        got = port_weights.convert_t5_state_dict({k: torch.from_numpy(v)
                                                  for k, v in sd.items()})
        _assert_trees_equal(got, want)
        _assert_trees_equal(got, t5[gated][3])


# -- the pipeline -------------------------------------------------------------


@pytest.fixture(scope="module")
def trees(dit, t5):
    """(DiT, T5, VAE) configs and JAX trees of the tiny pipeline."""
    jcfg, jp, _, _ = dit
    t5cfg, t5p, _, _ = t5[True]
    vp = jax_layout(port_vae.init_vae_params(torch.Generator().manual_seed(9),
                                             port_vae.tiny_vae_config()))
    return jcfg, jp, t5cfg, t5p, jax_vae.tiny_vae_config(), vp


def _latents(n=2, seed=11):
    return np.random.RandomState(seed).randn(n, 16, 16, 4).astype(np.float32)


def _jax_pipe(devices8, trees, scheduler, **fields):
    jcfg, jp, t5cfg, t5p, vcfg, vp = trees
    cfg = JaxDistriConfig(devices=devices8[:1], height=128, width=128, batch_size=2,
                          **fields)
    return jax_pipelines.DistriPixArtPipeline.from_params(
        cfg, jcfg, jp, vcfg, vp, t5_config=t5cfg, t5_params=t5p, scheduler=scheduler)


def _port_pipe(trees, scheduler, **fields):
    jcfg, jp, t5cfg, t5p, vcfg, vp = trees
    cfg = DistriConfig(device="cpu", height=128, width=128, batch_size=2, **fields)
    return port_pipelines.DistriPixArtPipeline.from_params(
        cfg, port_dit.tiny_dit_config(depth=2), params_from_jax(jax.device_get(jp)),
        port_vae.tiny_vae_config(), params_from_jax(vp),
        t5_config=port_t5.tiny_t5_config(), t5_params=params_from_jax(jax.device_get(t5p)),
        scheduler=scheduler)


@pytest.mark.parametrize("scheduler", ["ddim", "dpm-solver"])
def test_pipeline_matches_jax(devices8, trees, scheduler):
    """Two prompts, CFG on, 3 steps to latents; the encoded captions and
    masks (hash tokenizer, sentinel EOS attended) equal the JAX ones."""
    jpipe, ppipe = _jax_pipe(devices8, trees, scheduler), _port_pipe(trees, scheduler)
    jemb, jmask = jpipe._encode(PROMPTS, ["", "blurry"])
    pemb, pmask = ppipe._encode(PROMPTS, ["", "blurry"])
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    _close(pemb, jemb)
    kw = dict(num_inference_steps=3, output_type="latent")
    want = np.stack(jpipe(PROMPTS, latents=_latents(), **kw).images)
    steps = []
    got = np.stack(ppipe(PROMPTS, latents=_latents(), callback=lambda i, t, x: steps.append(i),
                         **kw).images)
    assert steps == [0, 1, 2] and np.isfinite(got).all()
    _close(got, want)
    image = ppipe(PROMPTS[:1], latents=_latents(1), num_inference_steps=1,
                  output_type="np").images[0]
    assert image.shape == (32, 32, 3) and np.isfinite(image).all()


def test_quantized_pipeline_matches_jax(devices8, trees):
    """int8 under quant_compute="pallas": the same payloads and scales from
    the same dense weights (the size conditioning folded first), latents
    within the quantized pipelines' limits, and 2e-4 densified."""
    quant = dict(weight_quant="int8", quant_compute="pallas")
    jpipe, ppipe = _jax_pipe(devices8, trees, "ddim", **quant), _port_pipe(trees, "ddim",
                                                                          **quant)
    want_tree = params_from_jax(jax.device_get(jpipe.runner.params))
    pairs = list(zip(_quantized_leaves(ppipe.runner.params), _quantized_leaves(want_tree)))
    assert len(pairs) == 2 * 8 + 6  # 8 a block; proj_in, t_fc1/2, adaln, cap_fc1/2
    for got, want in pairs:
        assert isinstance(got, QuantizedTensor) and got.compute == "pallas"
        assert torch.equal(got.payload, want.payload) and torch.equal(got.scale, want.scale)
    assert not isinstance(ppipe.runner.params["final_out"]["kernel"], QuantizedTensor)
    kw = dict(num_inference_steps=2, output_type="latent")
    want = np.stack(jpipe(PROMPTS, latents=_latents(), **kw).images)
    got = np.stack(ppipe(PROMPTS, latents=_latents(), **kw).images)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= PIPE_REL_L2 and np.abs(got - want).max() <= PIPE_MAX, rel
    jpipe.set_quant_compute("off")
    ppipe.set_quant_compute("off")
    want = np.stack(jpipe(PROMPTS, latents=_latents(), **kw).images)
    got = np.stack(ppipe(PROMPTS, latents=_latents(), **kw).images)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_weight_free_pipeline_runs():
    """Without T5 weights the captions are seeded pseudo-embeddings (drawn
    from a torch.Generator: not the JAX package's numbers), every token
    attended; the same prompt gives the same latent."""
    pcfg = port_dit.tiny_dit_config(depth=2)
    gen = torch.Generator().manual_seed(0)
    vcfg = port_vae.tiny_vae_config()
    cfg = DistriConfig(device="cpu", height=128, width=128)
    pipe = port_pipelines.DistriPixArtPipeline.from_params(
        cfg, pcfg, port_dit.init_dit_params(gen, pcfg), vcfg,
        port_vae.init_vae_params(gen, vcfg))
    emb, mask = pipe._encode(["a cat"], [""])
    assert emb.shape == (2, 1, 120, 32) and bool((mask == 1).all())
    a, b = (pipe("a cat", num_inference_steps=2, output_type="latent", seed=3).images[0]
            for _ in range(2))
    np.testing.assert_array_equal(a, b)
    assert pipe("a cat", num_inference_steps=2, output_type="latent").images[0].shape == (
        16, 16, 4)


# -- tokenizers ---------------------------------------------------------------


def precompiled_charsmap(mapping):
    """A SentencePiece precompiled character map for {key: replacement}:
    the u32 trie size, a Darts double array (each node's children in a
    256-unit block of their own: a child with label c at base | c, a key's
    value at base | 0), then the NUL-ended replacement strings."""
    strings, trie = b"", {}
    for key, value in mapping.items():
        node = trie
        for c in key.encode():
            node = node.setdefault(c, {})
        node[None] = len(strings)
        strings += value.encode() + b"\0"
    units, blocks = {}, [0]

    def place(node, pos):
        base = 256 * len(blocks)
        blocks.append(base)
        label = units.get(pos, 0) & 0xFF
        units[pos] = ((pos ^ base) << 10) | (int(None in node) << 8) | label
        if None in node:
            units[base] = (1 << 31) | node[None]
        for c, child in node.items():
            if c is not None:
                units[base | c] = c
                place(child, base | c)

    place(trie, 0)
    size = 256 * len(blocks)
    return (struct.pack("<I", 4 * size)
            + struct.pack(f"<{size}I", *(units.get(i, 0) for i in range(size))) + strings)


TOKEN_WORDS = ["▁", "a", "b", "c", "▁a", "▁ab", "ab", "abc", "▁abc", "fi", "▁fi", "é", "▁é",
               "x", "▁x", "▁the", "the", "▁photo", "ph", "o", "t", "h", "e", "p", "▁cat",
               "▁an"]
_PRECOMPILED = {"type": "Precompiled", "precompiled_charsmap": base64.b64encode(
    precompiled_charsmap({"Ａ": "a", "ﬁ": "fi", "é": "é", "Ｂ": "b", "　": " "})).decode()}
_REPLACE = {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}
_METASPACE = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
              "split": True}
TOKENIZER_FORMS = {
    "precompiled_metaspace": ({"type": "Sequence", "normalizers": [_PRECOMPILED, _REPLACE]},
                              _METASPACE),
    "precompiled_whitespace": (_PRECOMPILED, {"type": "Sequence", "pretokenizers": [
        {"type": "WhitespaceSplit"},
        {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True}]}),
    "nfkc": ({"type": "NFKC"}, _METASPACE),
}
TOKEN_TEXTS = ["a photo", "ＡＢc  abc", "ﬁ the   photo", "é é x", "zzz ab ☃☃ q", "",
               "the </s> ab", "abc" * 50, "a　b", "an abc photo of the cat"]


def write_tokenizer(d, form="precompiled_metaspace"):
    """A T5-style tokenizer.json (Unigram over TOKEN_WORDS with seeded
    scores, <pad> </s> <unk> as ids 0-2, EOS appended) and its
    tokenizer_config.json."""
    normalizer, pre = TOKENIZER_FORMS[form]
    rs = np.random.RandomState(0)
    vocab = [["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0]]
    vocab += [[w, float(-rs.uniform(1, 8))] for w in TOKEN_WORDS]
    eos = {"SpecialToken": {"id": "</s>", "type_id": 0}}
    seq = {"Sequence": {"id": "A", "type_id": 0}}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": t, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for i, t in enumerate(["<pad>", "</s>", "<unk>"])],
        "normalizer": normalizer, "pre_tokenizer": pre,
        "post_processor": {"type": "TemplateProcessing", "single": [seq, eos],
                           "pair": [seq, eos, {"Sequence": {"id": "B", "type_id": 0}}, eos],
                           "special_tokens": {"</s>": {"id": "</s>", "ids": [1],
                                                       "tokens": ["</s>"]}}},
        "decoder": _METASPACE,
        "model": {"type": "Unigram", "unk_id": 2, "vocab": vocab, "byte_fallback": False},
    }
    d.mkdir(parents=True, exist_ok=True)
    (d / "tokenizer.json").write_text(json.dumps(spec), encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>",
        "eos_token": "</s>", "unk_token": "<unk>", "model_max_length": 512}))


@pytest.mark.parametrize("form", sorted(TOKENIZER_FORMS))
def test_unigram_matches_transformers(tmp_path, form):
    transformers = pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    write_tokenizer(tmp_path, form)
    want = transformers.AutoTokenizer.from_pretrained(str(tmp_path))(
        TOKEN_TEXTS, padding="max_length", max_length=120, truncation=True,
        return_tensors="np")
    got = UnigramTokenizer(str(tmp_path))(TOKEN_TEXTS, padding="max_length", max_length=120,
                                          truncation=True, return_tensors="np")
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])


def test_unigram_refuses_what_it_cannot_read(tmp_path):
    with pytest.raises(OSError):
        UnigramTokenizer(str(tmp_path / "missing"))
    write_tokenizer(tmp_path)
    spec = json.loads((tmp_path / "tokenizer.json").read_text(encoding="utf-8"))
    spec["normalizer"] = {"type": "BertNormalizer"}
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec), encoding="utf-8")
    with pytest.raises(ValueError, match="BertNormalizer"):
        UnigramTokenizer(str(tmp_path))


def test_simple_tokenizer_fallback_matches_jax(tmp_path, capsys):
    """No tokenizer.json: the loud warning and the hash SimpleTokenizer with
    T5's ids (EOS 1, BOS 0), id for id the JAX one's."""
    tok = port_pipelines._t5_tokenizer_or_fallback(str(tmp_path / "tokenizer"), 32128)
    assert "WARNING" in capsys.readouterr().err
    want = jax_pipelines.SimpleTokenizer(vocab_size=32128, eos=1, bos=0)
    assert isinstance(tok, port_pipelines.SimpleTokenizer)
    texts = PROMPTS + ["", " ".join(["word"] * 200)]
    np.testing.assert_array_equal(tok(texts, 120), want(texts, 120))


# -- from_pretrained ----------------------------------------------------------


def test_from_pretrained_matches_jax(tmp_path, devices8):
    """A PixArt snapshot (transformer/, vae/, text_encoder/, tokenizer/,
    each with its config.json) that the test writes: both packages'
    ``from_pretrained`` on it give the same latent from the same noise."""
    root = tmp_path / "snap"
    for name, cfg_json, sd, fname in (
            ("transformer", PIXART_JSON, synthetic_pixart_sd(seed=12),
             "diffusion_pytorch_model.safetensors"),
            ("text_encoder", {"d_model": 32, "d_kv": 8, "d_ff": 48, "num_layers": 3,
                              "num_heads": 4, "vocab_size": 128,
                              "feed_forward_proj": "gated-gelu"},
             t5_state_dict(_seeded(port_t5.init_t5_params, port_t5.tiny_t5_config(), 13)[0]),
             "model.safetensors")):
        (root / name).mkdir(parents=True)
        (root / name / "config.json").write_text(json.dumps(cfg_json))
        save_file(sd, str(root / name / fname))
    vsd = {}
    invert_tree(jax_layout(port_vae.init_vae_params(torch.Generator().manual_seed(14),
                                                    port_vae.tiny_vae_config())), "", vsd)
    (root / "vae").mkdir()
    save_file({k: np.ascontiguousarray(v) for k, v in vsd.items()},
              str(root / "vae" / "diffusion_pytorch_model.safetensors"))
    (root / "vae" / "config.json").write_text(json.dumps(
        {"block_out_channels": [16, 32], "layers_per_block": 1, "norm_num_groups": 8,
         "scaling_factor": 0.18215}))
    write_tokenizer(root / "tokenizer")
    jcfg = JaxDistriConfig(devices=devices8[:1], height=128, width=128, dtype=jnp.float32)
    jpipe = jax_pipelines.DistriPixArtPipeline.from_pretrained(jcfg, str(root),
                                                               scheduler="ddim")
    ppipe = port_pipelines.DistriPixArtPipeline.from_pretrained(
        DistriConfig(device="cpu", height=128, width=128), str(root), scheduler="ddim")
    assert isinstance(ppipe.tokenizer, UnigramTokenizer)
    assert ppipe.dit_config == port_dit.dit_config_from_json(PIXART_JSON)
    jemb, jmask = jpipe._encode(["an abc photo of the cat"], [""])
    pemb, pmask = ppipe._encode(["an abc photo of the cat"], [""])
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    _close(pemb, jemb)
    kw = dict(num_inference_steps=2, output_type="latent")
    want = jpipe("an abc photo of the cat", latents=_latents(1), **kw).images[0]
    got = ppipe("an abc photo of the cat", latents=_latents(1), **kw).images[0]
    _close(got, want)


# -- the command line -----------------------------------------------------------


def test_dit_example_cli(tmp_path, capsys):
    """cli/dit_example.py: random tiny weights on the CPU to a latent file,
    displaced and under PipeFusion (4 chunks), and the JAX script's and
    runners' refusals."""
    from distrifuser_tpu_torch.cli import dit_example

    base = ["--device", "cpu", "--tiny_model", "--num_inference_steps", "2"]
    assert dit_example.main(base + ["--output_path", str(tmp_path / "o.png")]) == 0
    latent = np.load(tmp_path / "o.npy")
    assert latent.shape == (1, 16, 16, 4) and np.isfinite(latent).all()
    assert dit_example.main(base + ["--parallelism", "pipefusion", "--pipe_patches", "4",
                                    "--output_path", str(tmp_path / "p.png")]) == 0
    latent = np.load(tmp_path / "p.npy")
    assert latent.shape == (1, 16, 16, 4) and np.isfinite(latent).all()
    for argv, msg in ((["--parallelism", "tensor"], "UNet strategy"),
                      (["--init_image", "x.png"], "text2img-only"),
                      (["--parallelism", "pipefusion", "--pipe_patches", "3"],
                       "divisible by pipe_patches"),
                      (["--parallelism", "pipefusion", "--no_cuda_graph"],
                       "use_cuda_graph=False"),
                      (["--attn_impl", "usp", "--ulysses_degree", "2"],
                       "must divide the sp degree")):
        with pytest.raises(SystemExit):
            dit_example.main(base + argv)
        assert msg in capsys.readouterr().err, argv
