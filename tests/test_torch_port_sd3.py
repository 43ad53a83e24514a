"""PyTorch port: SD3 (the MMDiT, the rectified-flow sampler and
DistriSD3Pipeline) against the JAX package.

The same inputs, made from numpy seeds, go through the JAX function and its
counterpart in the port, on the CPU in float32, at the tiny sizes
(``tiny_mmdit_config``: width 32, 4 heads, a 16x16 token grid):

* the MMDiT's modules (``pos_embed_cropped``, ``cond_vec``, ``_rms_heads``,
  ``mmdit_block`` plain, qk_norm and dual, dense and through its
  ``kv_assemble`` / ``attn_core`` / ``kv2_assemble`` / ``attn2_core``
  hooks, ``final_layer``) within rtol 1e-4 / atol 1e-5, ``mmdit_forward``
  plain, qk_norm and dual within 5e-4 of the largest value;
* ``convert_mmdit_state_dict`` on a synthetic diffusers state dict with a
  ``context_pre_only`` last block, SD3.5's q/k norms and an
  AdaLayerNormZeroX dual prefix: the JAX converter's tree, carried across
  by ``params_from_jax`` (which unstacks ``blocks`` and ``blocks_dual``),
  equals the port's leaf for leaf; the config readers and their refusals;
* the flow sampler's sigmas, timesteps, ``step`` and ``add_noise`` (also
  per row) against the JAX ``FlowMatchEulerScheduler``, and the sampler
  families refused crosswise;
* ``DistriSD3Pipeline`` with CFG on, 3 flow-euler steps, to latents within
  5e-4 of the JAX pipeline on the same weights and noise: without T5 (zero
  T5 states), with the tiny T5, img2img from an image (the JAX noise
  passed in), int8 under ``quant_compute="pallas"`` from the same payloads
  and scales (within the quantized pipelines' limits); the decode with the
  VAE's ``shift_factor``;
* ``from_pretrained`` over a snapshot the test writes (safetensors shards,
  config.json files, the scheduler's flow shift, no T5) gives the JAX
  ``from_pretrained``'s latent on it;
* ``cli/sd3_example.py``: its flags, defaults and refusals;
* ``chip_smoke.py``'s relative check of the flash kernel's "@sd3" rows:
  a sound result passes it and one without the last KV tile fails it, at
  the rows' key lengths and statistics.

The multi-rank runner is tests/test_torch_port_mmdit_sp.py.
"""

import dataclasses
import importlib.util
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from safetensors.numpy import save_file

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu import pipelines as jax_pipelines
from distrifuser_tpu.models import clip as jax_clip
from distrifuser_tpu.models import mmdit as jax_mm
from distrifuser_tpu.models import t5 as jax_t5
from distrifuser_tpu.models import vae as jax_vae
from distrifuser_tpu.models import weights as jax_weights
from distrifuser_tpu.schedulers import get_scheduler as jax_scheduler
from distrifuser_tpu_torch import DistriConfig
from distrifuser_tpu_torch import pipelines as port_pipelines
from distrifuser_tpu_torch.cli import sd3_example
from distrifuser_tpu_torch.models import clip as port_clip
from distrifuser_tpu_torch.models import mmdit as port_mm
from distrifuser_tpu_torch.models import t5 as port_t5
from distrifuser_tpu_torch.models import vae as port_vae
from distrifuser_tpu_torch.models import weights as port_weights
from distrifuser_tpu_torch.models.weights import params_from_jax
from distrifuser_tpu_torch.ops import flash_attention as port_fa
from distrifuser_tpu_torch.parallel.compress import QuantizedTensor
from distrifuser_tpu_torch.schedulers import FlowMatchEulerScheduler, get_scheduler
from test_mmdit_weights import synth_sd
from test_torch_port_pixart import _assert_trees_equal
from test_torch_port_quant_pipeline import PIPE_MAX, PIPE_REL_L2
from test_torch_port_ranks import jax_layout
from test_torch_port_sd_quant import _quantized_leaves
from test_torch_port_snapshots import jax_reads_shards_with_safetensors  # noqa: F401
from test_weights_roundtrip import invert_tree

RTOL, ATOL = 1e-4, 1e-5
TOL = 5e-4  # whole model and pipeline: max |d| / max |ref|
PROMPTS = ["a photo of the cat", "an abc photo"]
# the MMDiT variants: SD3's, SD3.5's q/k norms, SD3.5-medium's dual prefix
VARIANTS = {"plain": {}, "qk_norm": {"qk_norm": True},
            "dual": {"qk_norm": True, "depth": 3, "dual_attention_blocks": 2}}


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
    """A port tree as the JAX package holds it (``jax_layout``), the stacked
    keys (the MMDiT's blocks and dual prefix, T5's layers) stacked on a
    leading axis: seeding with the port's init is much cheaper than the
    JAX package's op-by-op init."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("blocks", "blocks_dual", "layers") and isinstance(v, list):
                out[k] = jax.tree.map(lambda *ls: np.stack(ls), *jax_layout(v))
            else:
                out[k] = jax_tree(v)
        return out
    return jax_layout(tree)


def seeded_mmdit(variant, seed=0):
    """(JAX config, JAX params, port config, port params) of a tiny MMDiT of
    ``variant`` (VARIANTS), depth 2 unless the variant says."""
    fields = {"depth": 2, **VARIANTS[variant]}
    pcfg = dataclasses.replace(port_mm.tiny_mmdit_config(), **fields)
    jcfg = dataclasses.replace(jax_mm.tiny_mmdit_config(), **fields)
    tree = jax_tree(port_mm.init_mmdit_params(torch.Generator().manual_seed(seed), pcfg))
    # unit norms and zero biases would hide a swapped leaf: perturb them
    rs = np.random.RandomState(seed)
    tree = jax.tree.map(lambda a: a + 0.1 * rs.randn(*a.shape).astype(a.dtype), tree)
    return jcfg, jax.tree.map(jnp.asarray, tree), pcfg, params_from_jax(tree)


@pytest.fixture(scope="module")
def mmdits():
    return {v: seeded_mmdit(v, i) for i, v in enumerate(VARIANTS)}


# -- the MMDiT's modules --------------------------------------------------------


def test_configs_match_jax():
    for port_cfg, jax_cfg in ((port_mm.sd3_config(), jax_mm.sd3_config()),
                              (port_mm.sd3_config(64), jax_mm.sd3_config(64)),
                              (port_mm.tiny_mmdit_config(), jax_mm.tiny_mmdit_config())):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    sd35m = {"num_layers": 24, "num_attention_heads": 24, "attention_head_dim": 64,
             "qk_norm": "rms_norm", "dual_attention_layers": list(range(13)),
             "pos_embed_max_size": 384, "joint_attention_dim": 4096}
    got = port_mm.mmdit_config_from_json(sd35m)
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_mm.mmdit_config_from_json(sd35m))
    assert got.dual_attention_blocks == 13 and got.qk_norm and got.head_dim == 64
    for bad, match in (({"qk_norm": "layer_norm"}, "qk_norm"),
                       ({"dual_attention_layers": [1, 2]}, "contiguous-prefix")):
        for reader in (port_mm.mmdit_config_from_json, jax_mm.mmdit_config_from_json):
            with pytest.raises(ValueError, match=match):
                reader(bad)
    with pytest.raises(ValueError, match="pos_embed_max_size"):
        port_mm.MMDiTConfig(sample_size=512, pos_embed_max_size=192)


def test_embeddings_match_jax(mmdits):
    jcfg, jp, pcfg, pp = mmdits["plain"]
    for fields in ({}, {"sample_size": 24}):
        want = jax_mm.pos_embed_cropped(dataclasses.replace(jcfg, **fields))
        _op_close(port_mm.pos_embed_cropped(dataclasses.replace(pcfg, **fields)), want)
    pooled = np.random.RandomState(1).randn(2, 24).astype(np.float32)
    for t in (1000.0, 417.5, np.float32([750.0, 3.0])):
        want = jax_mm.cond_vec(jp, jcfg, jnp.asarray(t), jnp.asarray(pooled))
        _op_close(port_mm.cond_vec(pp, pcfg, torch.tensor(t), _t(pooled)), want)
    x = np.random.RandomState(2).randn(2, 5, 32).astype(np.float32)
    w = np.random.RandomState(3).rand(8).astype(np.float32)
    _op_close(port_mm._rms_heads(_t(x), _t(w), 4), jax_mm._rms_heads(jnp.asarray(x),
                                                                     jnp.asarray(w), 4))


def _block_inputs(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(2, 12, 32).astype(np.float32), rs.randn(2, 5, 32).astype(np.float32),
            rs.randn(2, 32).astype(np.float32), rs.randn(2, 20, 64).astype(np.float32))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mode", ["dense", "hooks"])
def test_mmdit_block_matches_jax(mmdits, variant, mode):
    """Block 0 of each variant, dense and through its hooks: kv_assemble
    appends a fixed image KV, attn_core attends the context KV against the
    image KV reversed, and for a dual block kv2_assemble / attn2_core do the
    same to the dual attention's KV."""
    jcfg, jp, pcfg, pp = mmdits[variant]
    from distrifuser_tpu.ops.attention import sdpa as jax_sdpa
    from distrifuser_tpu_torch.ops.attention import sdpa

    x, ctx, vec, extra = _block_inputs(4)
    h = jcfg.hidden_size
    dual = variant == "dual"
    jbp = jax.tree.map(lambda a: a[0], jp["blocks"])
    jdp = jax.tree.map(lambda a: a[0], jp["blocks_dual"]) if dual else None
    jkw, pkw = {}, {}
    if mode == "hooks":
        cat = lambda a, b: jnp.concatenate([a, jnp.asarray(b)], 1)  # noqa: E731
        jkw["kv_assemble"] = lambda k, v: (cat(k, extra[..., :h]), cat(v, extra[..., h:]))
        pkw["kv_assemble"] = lambda kv: torch.cat([kv, _t(extra)], 1)
        if dual:
            jkw["attn2_core"] = lambda q, kv: jax_sdpa(q, kv[0][:, ::-1], kv[1][:, ::-1] * 2,
                                                       heads=4)

            def core2(q, kv):
                k, v = kv.flip(1).chunk(2, -1)
                return sdpa(q, k, v * 2, heads=4)
            pkw["attn2_core"] = core2
    want = jax_mm.mmdit_block(jbp, jcfg, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(vec),
                              dual_p=jdp, **jkw)
    got = port_mm.mmdit_block(pp["blocks"][0], pcfg, _t(x), _t(ctx), _t(vec),
                              dual_p=pp["blocks_dual"][0] if dual else None, **pkw)
    assert len(got) == len(want) == (4 if dual else 3)
    _op_close(got[0], want[0])
    _op_close(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):  # the fresh fused KV, k then v
        _op_close(g, np.concatenate([np.asarray(w[0]), np.asarray(w[1])], -1))
    if mode == "hooks":  # attn_core: joint queries against the image KV reversed
        want = jax_mm.mmdit_block(
            jbp, jcfg, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(vec),
            attn_core=lambda cq, xq, ckv, xkv: jax_sdpa(
                jnp.concatenate([cq, xq], 1), jnp.concatenate([ckv[0], xkv[0][:, ::-1]], 1),
                jnp.concatenate([ckv[1], xkv[1][:, ::-1]], 1), heads=4))

        def core(cq, xq, ckv, xkv):
            (ck, cv), (k, v) = ckv.chunk(2, -1), xkv.flip(1).chunk(2, -1)
            return sdpa(torch.cat([cq, xq], 1), torch.cat([ck, k], 1), torch.cat([cv, v], 1),
                        heads=4)
        got = port_mm.mmdit_block(pp["blocks"][0], pcfg, _t(x), _t(ctx), _t(vec),
                                  attn_core=core)
        _op_close(got[0], want[0])
        _op_close(got[1], want[1])
    _op_close(port_mm.final_layer(pp, pcfg, _t(x), _t(vec)),
              jax_mm.final_layer(jp, jcfg, jnp.asarray(x), jnp.asarray(vec)))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mmdit_forward_matches_jax(mmdits, variant):
    jcfg, jp, pcfg, pp = mmdits[variant]
    rs = np.random.RandomState(5)
    x = rs.randn(2, 32, 32, 4).astype(np.float32)
    enc = rs.randn(2, 9, 32).astype(np.float32)
    pooled = rs.randn(2, 24).astype(np.float32)
    want = jax_mm.mmdit_forward(jp, jcfg, jnp.asarray(x), jnp.float32(601.0),
                                jnp.asarray(enc), jnp.asarray(pooled))
    got = port_mm.mmdit_forward(pp, pcfg, _t(x), torch.tensor(601.0), _t(enc), _t(pooled))
    assert got.dtype == torch.float32 and got.shape == (2, 32, 32, 4)
    _close(got, want)


# -- the converter ---------------------------------------------------------------


def _sd35_state_dict():
    """A synthetic SD3.5-medium-layout state dict: three blocks, the first
    two with the dual attention (9-chunk AdaLayerNormZeroX, attn2 and its
    q/k norms), q/k norms on every block, the last context_pre_only."""
    cfg = dataclasses.replace(jax_mm.tiny_mmdit_config(), depth=3, dual_attention_blocks=2)
    sd = synth_sd(seed=7, n_dual=2, cfg=cfg)
    rs = np.random.RandomState(8)
    d = cfg.hidden_size // cfg.num_heads
    for i in range(cfg.depth):
        b = f"transformer_blocks.{i}"
        names = ["attn.norm_q", "attn.norm_k", "attn.norm_added_k"]
        names += [] if i == cfg.depth - 1 else ["attn.norm_added_q"]
        names += ["attn2.norm_q", "attn2.norm_k"] if i < 2 else []
        for name in names:
            sd[f"{b}.{name}.weight"] = rs.rand(d).astype(np.float32)
    return sd


@pytest.mark.parametrize("layout", ["sd3", "sd35_medium"])
def test_convert_mmdit_state_dict_matches_jax(layout):
    sd = synth_sd(seed=6) if layout == "sd3" else _sd35_state_dict()
    want = params_from_jax(jax.device_get(jax_weights.convert_mmdit_state_dict(sd)))
    got = port_weights.convert_mmdit_state_dict({k: torch.from_numpy(v)
                                                 for k, v in sd.items()})
    _assert_trees_equal(got, want)
    last = got["blocks"][-1]
    h = last["x_out"]["kernel"].shape[0]
    # the discarded context stream of the last block: zero queries, output,
    # MLP, gate and MLP modulation
    assert not last["c_qkv"]["kernel"][:, :h].any() and not last["c_out"]["kernel"].any()
    assert not last["c_mod"]["kernel"][:, 2 * h:].any()
    if layout == "sd35_medium":
        assert len(got["blocks_dual"]) == 2 and torch.equal(last["c_qnorm"],
                                                            torch.ones(h // 4))
        w9 = sd["transformer_blocks.0.norm1.linear.weight"]
        np.testing.assert_array_equal(got["blocks_dual"][0]["x_mod2"]["kernel"].numpy(),
                                      w9[6 * h:].T)


def test_converted_tree_forward_matches_jax():
    """The SD3.5-medium-layout tree, converted on both sides, through
    ``mmdit_forward``."""
    sd = _sd35_state_dict()
    jcfg = dataclasses.replace(jax_mm.tiny_mmdit_config(), depth=3, dual_attention_blocks=2,
                               qk_norm=True)
    pcfg = dataclasses.replace(port_mm.tiny_mmdit_config(), depth=3, dual_attention_blocks=2,
                               qk_norm=True)
    rs = np.random.RandomState(9)
    x, enc, pooled = (rs.randn(1, 32, 32, 4), rs.randn(1, 6, 32), rs.randn(1, 24))
    want = jax_mm.mmdit_forward(jax_weights.convert_mmdit_state_dict(sd), jcfg,
                                jnp.float32(x), jnp.float32(250.0), jnp.float32(enc),
                                jnp.float32(pooled))
    got = port_mm.mmdit_forward(
        port_weights.convert_mmdit_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}),
        pcfg, _t(x), torch.tensor(250.0), _t(enc), _t(pooled))
    _close(got, want)


# -- the flow sampler -------------------------------------------------------------


@pytest.mark.parametrize("shift", [3.0, 1.0])
def test_flow_scheduler_matches_jax(shift):
    js = jax_scheduler("flow-euler", shift=shift)
    ps = get_scheduler("flow-euler", shift=shift)
    assert isinstance(ps, FlowMatchEulerScheduler) and ps.prediction_type == "flow"
    js.set_timesteps(5)
    ps.set_timesteps(5)
    np.testing.assert_array_equal(ps._sigmas.numpy(), np.asarray(js._sigmas))
    np.testing.assert_array_equal(ps.timesteps().numpy(), np.asarray(js.timesteps()))
    assert ps.init_state((1, 4)) == {} and ps.init_noise_sigma == 1.0
    rs = np.random.RandomState(2)
    x, v = rs.randn(2, 6, 4).astype(np.float32), rs.randn(2, 6, 4).astype(np.float32)
    for i in range(5):
        want, _ = js.step(jnp.asarray(x), jnp.asarray(v), i, {})
        got, _ = ps.step(_t(x), _t(v), i, {})
        _op_close(got, want)
        _op_close(ps.add_noise(_t(x), _t(v), i), js.add_noise(jnp.asarray(x), jnp.asarray(v), i))
    rows = np.int32([1, 3])  # per-row step indices
    _op_close(ps.add_noise(_t(x), _t(v), torch.from_numpy(rows)),
              js.add_noise(jnp.asarray(x), jnp.asarray(v), jnp.asarray(rows)))
    _op_close(ps.step(_t(x), _t(v), torch.from_numpy(rows), {})[0],
              js.step(jnp.asarray(x), jnp.asarray(v), jnp.asarray(rows), {})[0])


def test_scheduler_families_refused_crosswise():
    ddim, flow = get_scheduler("ddim"), get_scheduler("flow-euler")
    port_pipelines._check_scheduler_family(flow, "DistriSD3Pipeline", flow=True)
    with pytest.raises(ValueError, match="rectified-flow model family"):
        port_pipelines._check_scheduler_family(ddim, "DistriSD3Pipeline", flow=True)
    with pytest.raises(ValueError, match="'flow-euler' on DistriPixArtPipeline"):
        port_pipelines._check_scheduler_family(flow, "DistriPixArtPipeline")


# -- the pipeline -----------------------------------------------------------------


def _clip_configs(lib):
    """The tiny SD3 stack's CLIPs: hidden 16 + 16 (padded to the joint width
    32), projections 16 + 8 (the pooled width 24)."""
    return [lib.tiny_clip_config(hidden=16),
            lib.CLIPTextConfig(vocab_size=1000, hidden_size=16, num_hidden_layers=2,
                               num_attention_heads=4, intermediate_size=32, projection_dim=8)]


@pytest.fixture(scope="module")
def trees(mmdits):
    """JAX trees of the tiny SD3 pipeline: the plain MMDiT (depth 2), the
    CLIPs, the tiny T5 (its width is the joint width) and a VAE with a
    latent shift."""
    gen = torch.Generator().manual_seed(12)
    clips = [jax_layout(port_clip.init_clip_params(gen, tc)) for tc in _clip_configs(port_clip)]
    t5 = jax_tree(port_t5.init_t5_params(gen, port_t5.tiny_t5_config()))
    vae = jax_layout(port_vae.init_vae_params(gen, port_vae.tiny_vae_config()))
    return mmdits["plain"][1], clips, t5, vae


VAE_FIELDS = {"shift_factor": 0.1, "scaling_factor": 1.2}


def _jax_pipe(devices8, trees, t5=False, **fields):
    mp, clips, t5p, vp = trees
    jcfg = dataclasses.replace(jax_mm.tiny_mmdit_config(), depth=2)
    # the JAX package's per-step programs (its stepwise loop, the fused loop's
    # numerics) compile faster than its fused loop
    cfg = JaxDistriConfig(devices=devices8[:1], height=256, width=256, batch_size=2,
                          use_cuda_graph=False, **fields)
    return jax_pipelines.DistriSD3Pipeline.from_params(
        cfg, jcfg, mp, dataclasses.replace(jax_vae.tiny_vae_config(), **VAE_FIELDS), vp,
        _clip_configs(jax_clip), clips, t5_config=jax_t5.tiny_t5_config() if t5 else None,
        t5_params=t5p if t5 else None, max_t5_tokens=7)


def _port_pipe(trees, t5=False, **fields):
    mp, clips, t5p, vp = trees
    cfg = DistriConfig(device="cpu", height=256, width=256, batch_size=2, **fields)
    carry = lambda tree: params_from_jax(jax.device_get(tree))  # noqa: E731
    return port_pipelines.DistriSD3Pipeline.from_params(
        cfg, dataclasses.replace(port_mm.tiny_mmdit_config(), depth=2), carry(mp),
        dataclasses.replace(port_vae.tiny_vae_config(), **VAE_FIELDS), carry(vp),
        _clip_configs(port_clip), [carry(c) for c in clips],
        t5_config=port_t5.tiny_t5_config() if t5 else None,
        t5_params=carry(t5p) if t5 else None, max_t5_tokens=7)


def _latents(n=2, seed=11):
    return np.random.RandomState(seed).randn(n, 32, 32, 4).astype(np.float32)


KW = dict(num_inference_steps=3, output_type="latent")


@pytest.mark.parametrize("t5", [False, True], ids=["no_t5", "t5"])
def test_pipeline_matches_jax(devices8, trees, t5):
    """Two prompts, CFG on, 3 flow-euler steps to latents; the encoded text
    states and pooled vectors (hash tokenizers; the T5 mask keeps the first
    EOS) equal the JAX ones; with T5 one prompt also decodes to an image
    (the latent shift added back) equal to the JAX one."""
    jpipe, ppipe = _jax_pipe(devices8, trees, t5), _port_pipe(trees, t5)
    jenc, jpooled = jpipe._encode(PROMPTS, ["", "blurry"])
    penc, ppooled = ppipe._encode(PROMPTS, ["", "blurry"])
    assert penc.shape == (2, 2, 77 + 7, 32) and ppooled.shape == (2, 2, 24)
    _close(penc, jenc)
    _close(ppooled, jpooled)
    assert bool(penc[:, :, 77:].any()) == t5
    want = np.stack(jpipe(PROMPTS, latents=_latents(), **KW).images)
    steps = []
    got = np.stack(ppipe(PROMPTS, latents=_latents(), callback=lambda i, t, x: steps.append(i),
                         **KW).images)
    assert steps == [0, 1, 2] and np.isfinite(got).all()
    _close(got, want)
    if t5:
        kw = dict(num_inference_steps=1, output_type="np")
        want = jpipe(PROMPTS[:1], latents=_latents(1), **kw).images[0]
        got = ppipe(PROMPTS[:1], latents=_latents(1), **kw).images[0]
        assert got.shape == (64, 64, 3)  # the tiny VAE upsamples twice
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_img2img_matches_jax(devices8, trees):
    """img2img at strength 0.5 of 4 steps: the image encoded, its shift
    removed and scaled, moved to sigma of step 2 by the flow add_noise with
    the JAX package's noise, steps 2 and 3 run."""
    image = np.random.RandomState(3).randint(0, 256, (64, 64, 3), dtype=np.uint8)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(5), (1, 32, 32, 4), jnp.float32))
    kw = dict(image=image, strength=0.5, num_inference_steps=4, seed=5,
              output_type="latent")
    want = _jax_pipe(devices8, trees)(PROMPTS[0], **kw).images[0]
    steps = []
    got = _port_pipe(trees)(PROMPTS[0], _noise=noise,
                            callback=lambda i, t, x: steps.append(i), **kw).images[0]
    assert steps == [2, 3]
    _close(got, want)


def test_quantized_pipeline_matches_jax(devices8, trees):
    """int8 under quant_compute="pallas": the same payloads and scales from
    the same dense weights, latents within the quantized pipelines'
    limits."""
    quant = dict(weight_quant="int8", quant_compute="pallas")
    jpipe, ppipe = _jax_pipe(devices8, trees, **quant), _port_pipe(trees, **quant)
    want_tree = params_from_jax(jax.device_get(jpipe.runner.params))
    pairs = list(zip(_quantized_leaves(ppipe.runner.params), _quantized_leaves(want_tree)))
    assert len(pairs) == 2 * 10 + 7  # 10 a block; proj_in, ctx_in, t/pool fc1/2, final_mod
    for got, want in pairs:
        assert isinstance(got, QuantizedTensor) and got.compute == "pallas"
        assert torch.equal(got.payload, want.payload) and torch.equal(got.scale, want.scale)
    assert not isinstance(ppipe.runner.params["final_out"]["kernel"], QuantizedTensor)
    want = np.stack(jpipe(PROMPTS, latents=_latents(), **KW).images)
    got = np.stack(ppipe(PROMPTS, latents=_latents(), **KW).images)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= PIPE_REL_L2 and np.abs(got - want).max() <= PIPE_MAX, rel
    report = ppipe.weight_report()
    assert report["weight_quant"] == "int8" and report["per_component_nbytes"]["denoiser"] > 0


def test_pipeline_refusals(trees):
    with pytest.raises(ValueError, match="rectified-flow model family"):
        port_pipelines.DistriSD3Pipeline.from_params(
            DistriConfig(device="cpu", height=256, width=256),
            port_mm.tiny_mmdit_config(), {}, port_vae.tiny_vae_config(), {},
            _clip_configs(port_clip), [{}, {}], scheduler="ddim")
    wide = dataclasses.replace(port_mm.tiny_mmdit_config(), pooled_projection_dim=32)
    with pytest.raises(ValueError, match="pooled_projection_dim"):
        port_pipelines.DistriSD3Pipeline.from_params(
            DistriConfig(device="cpu", height=256, width=256), wide, {},
            port_vae.tiny_vae_config(), {}, _clip_configs(port_clip), [{}, {}])
    pipe = _port_pipe(trees)
    with pytest.raises(ValueError, match="fixed in DistriConfig"):
        pipe("x", height=512)
    assert pipe.comm_plan(4)["total_bytes"] == 0  # one device: nothing on the wire


# -- from_pretrained ------------------------------------------------------------------


def _write_snapshot(root, vp):
    """A diffusers-layout SD3 snapshot without T5: the synthetic transformer
    state dict and its config.json, two projection CLIPs from transformers,
    the VAE with a latent shift, the scheduler's flow shift 2."""
    import transformers

    from test_mmdit_weights import CFG as MCFG

    for sub in ("transformer", "vae", "text_encoder", "text_encoder_2", "scheduler"):
        (root / sub).mkdir(parents=True)
    (root / "transformer" / "config.json").write_text(json.dumps({
        "sample_size": MCFG.sample_size, "patch_size": MCFG.patch_size,
        "in_channels": MCFG.in_channels, "num_layers": MCFG.depth,
        "num_attention_heads": MCFG.num_heads,
        "attention_head_dim": MCFG.hidden_size // MCFG.num_heads,
        "joint_attention_dim": MCFG.joint_attention_dim,
        "pooled_projection_dim": MCFG.pooled_projection_dim,
        "pos_embed_max_size": MCFG.pos_embed_max_size}))
    save_file(synth_sd(), str(root / "transformer" / "diffusion_pytorch_model.safetensors"))
    for sub, proj in (("text_encoder", 16), ("text_encoder_2", 8)):
        fields = dict(vocab_size=1000, hidden_size=16, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=32,
                      max_position_embeddings=77, projection_dim=proj, eos_token_id=999)
        torch.manual_seed(proj)
        model = transformers.CLIPTextModelWithProjection(
            transformers.CLIPTextConfig(bos_token_id=998, **fields)).eval()
        save_file({k: v.numpy() for k, v in model.state_dict().items()},
                  str(root / sub / "model.safetensors"))
        (root / sub / "config.json").write_text(json.dumps(
            {"architectures": ["CLIPTextModelWithProjection"], **fields}))
    vsd = {}
    invert_tree(vp, "", vsd)
    save_file(vsd, str(root / "vae" / "diffusion_pytorch_model.safetensors"))
    (root / "vae" / "config.json").write_text(json.dumps({
        "block_out_channels": [16, 32], "layers_per_block": 1, "norm_num_groups": 8,
        **VAE_FIELDS}))
    (root / "scheduler" / "scheduler_config.json").write_text(json.dumps({
        "_class_name": "FlowMatchEulerDiscreteScheduler", "shift": 2.0,
        "num_train_timesteps": 1000}))


def test_from_pretrained_matches_jax(tmp_path, devices8, trees,
                                     jax_reads_shards_with_safetensors):  # noqa: F811
    _write_snapshot(tmp_path, trees[3])
    jcfg = JaxDistriConfig(devices=devices8[:1], height=256, width=256, dtype=jnp.float32,
                           use_cuda_graph=False)
    jpipe = jax_pipelines.DistriSD3Pipeline.from_pretrained(jcfg, str(tmp_path))
    pipe = port_pipelines.DistriSD3Pipeline.from_pretrained(
        DistriConfig(device="cpu", height=256, width=256), str(tmp_path))
    assert pipe.scheduler.shift == 2.0 and pipe.vae_config.shift_factor == 0.1
    assert pipe.t5 == (None, None) and pipe.tokenizers[2] is None
    assert dataclasses.asdict(pipe.mmdit_config) == dataclasses.asdict(jpipe.mmdit_config)
    kw = dict(latents=_latents(1), num_inference_steps=2, output_type="latent")
    _close(pipe("snapshot smoke", **kw).images[0], jpipe("snapshot smoke", **kw).images[0])
    with pytest.raises(ValueError, match="flow-euler"):
        port_pipelines.DistriSD3Pipeline.from_pretrained(
            DistriConfig(device="cpu", height=256, width=256), str(tmp_path),
            scheduler="ddim")
    with pytest.raises(FileNotFoundError):
        port_pipelines.DistriSD3Pipeline.from_pretrained(
            DistriConfig(device="cpu", height=256, width=256), str(tmp_path / "missing"))


# -- the command line --------------------------------------------------------------


TINY = ["--device", "cpu", "--random_weights", "--tiny_model", "--image_size", "256",
        "--num_inference_steps", "2", "--output_type", "latent"]


def test_sd3_example_runs(capsys):
    """The script's family defaults (flow-euler, guidance 7, 28 steps: the
    JAX scripts' ``FAMILY_DEFAULTS["sd3"]``) and a tiny run to latents."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    import common as jax_common

    from distrifuser_tpu_torch.cli import common

    assert common.FAMILY_DEFAULTS["sd3"] == jax_common.FAMILY_DEFAULTS["sd3"]
    args = sd3_example.build_parser().parse_args([])
    assert (args.scheduler, args.guidance_scale, args.num_inference_steps) == (
        "flow-euler", 7.0, 28)
    assert sd3_example.main(TINY) == 0


@pytest.mark.parametrize("flags, message", [
    (["--scheduler", "ddim"], "flow-euler"),
    (["--attn_impl", "ulysses"], "joint attention"),
    (["--attn_impl", "ring", "--comm_compress", "int8"], "comm_compress"),
    (["--parallelism", "tensor"], "parallelism"),
])
def test_sd3_example_refusals(capsys, flags, message):
    with pytest.raises(SystemExit) as e:
        sd3_example.main(TINY + flags)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("lk, block_k, d", [
    (4250, 128, 64),  # the dense joint call: 26 ragged keys
    (154, 128, 64),  # the ring's static context block: 26 ragged keys
    (4096, 64, 64),  # SD3.5-medium's dual attention, a tile of 64
    (2048, 128, 64),  # the ring's chunk
    (16384, 32, 512),  # the SD3 VAE's mid attention
])
def test_sd3_flash_check_sees_a_dropped_key_tile(lk, block_k, d):
    """chip_smoke.py holds the "@sd3" flash rows in units of the plain
    result's scale: bf16 q, k, v drawn N(0, 1) as the card's rows are, a
    sound result (float32 SDPA rounded to bf16) passes, and the plain result
    without the last KV tile fails the limits, which the absolute ones of the
    other rows (2e-2 / 2e-3) would let through at 4250 keys."""
    smoke = _chip_smoke()
    heads = 2 if d == 64 else 1
    rng = np.random.default_rng(lk)
    q, k, v = (torch.tensor(rng.standard_normal((1, n, heads * d)),
                            dtype=torch.float32).bfloat16() for n in (64, lk, lk))
    want = port_fa.flash_sdpa_reference(q, k, v, heads=heads)
    qh, kh, vh = (t.float().unflatten(-1, (heads, d)).transpose(1, 2) for t in (q, k, v))
    sound = F.scaled_dot_product_attention(qh, kh, vh).transpose(1, 2).flatten(2).bfloat16()
    keep = lk - smoke.tail_keys(lk, block_k)
    cut = port_fa.flash_sdpa_reference(q, k[:, :keep], v[:, :keep], heads=heads)
    readings = smoke.relative_check("sound", sound, want, cut)
    assert readings["tail_cut_rel_mean_err"] > 2 * smoke.SD3_REL_MEAN
    limits = re.escape(f"over {smoke.SD3_REL_MAX}/{smoke.SD3_REL_MEAN}")
    with pytest.raises(AssertionError, match=limits):
        smoke.relative_check("tail dropped", cut, want, cut)
