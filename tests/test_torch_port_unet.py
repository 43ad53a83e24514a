"""PyTorch port: the UNet forward against the JAX package.

The same JAX parameter tree (through ``params_from_jax``) and the same
numpy inputs go through JAX ``unet_forward`` and the port's, in float32 on
the CPU; the whole-UNet tolerance is 5e-4 (ROADMAP), with the text KV both
precomputed (the runner's path) and computed in place.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrifuser_tpu.models import unet as jax_unet
from distrifuser_tpu_torch.models import unet as port_unet
from distrifuser_tpu_torch.models.weights import params_from_jax

TOL = 5e-4


def _inputs(sdxl, seed=0):
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


@pytest.mark.parametrize("sdxl", [True, False], ids=["sdxl", "sd"])
@pytest.mark.parametrize("text_kv", [False, True], ids=["inline_kv", "cached_kv"])
def test_unet_forward_matches_jax(sdxl, text_kv):
    jcfg = jax_unet.tiny_config(cross_attention_dim=32, sdxl=sdxl)
    jparams = jax_unet.init_unet_params(jax.random.PRNGKey(0), jcfg)
    sample, t, enc, added = _inputs(sdxl)
    want = jax_unet.unet_forward(
        jparams, jcfg, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(enc),
        added_cond=None if added is None else jax.tree.map(jnp.asarray, added),
    )

    pcfg = port_unet.tiny_config(cross_attention_dim=32, sdxl=sdxl)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    pparams = params_from_jax(jax.device_get(jparams))
    penc = torch.from_numpy(enc)
    dispatch = port_unet.DenseDispatch(
        text_kv=port_unet.precompute_text_kv(pparams, penc) if text_kv else None)
    got = port_unet.unet_forward(
        pparams, pcfg, torch.from_numpy(sample), torch.from_numpy(t), penc,
        dispatch=dispatch,
        added_cond=None if added is None else
        {k: torch.from_numpy(v) for k, v in added.items()},
    )
    assert tuple(got.shape) == want.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_precompute_text_kv_keys_match_jax():
    jcfg = jax_unet.tiny_config(cross_attention_dim=32, sdxl=True)
    jparams = jax_unet.init_unet_params(jax.random.PRNGKey(1), jcfg)
    enc = np.random.RandomState(3).randn(2, 8, 32).astype(np.float32)
    want = jax_unet.precompute_text_kv(jparams, jnp.asarray(enc))
    got = port_unet.precompute_text_kv(params_from_jax(jax.device_get(jparams)),
                                       torch.from_numpy(enc))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-5)


def _shapes(tree, path=""):
    """{path: shape} of a nested dict/list tree of arrays or tensors."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shapes(sub, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _shapes(sub, f"{path}/{i}").items()}
    return {path: tuple(tree.shape)}


@pytest.mark.parametrize("sdxl", [True, False], ids=["sdxl", "sd"])
def test_port_init_matches_jax_tree_structure(sdxl):
    """The port's own random init builds the JAX tree's keys and shapes,
    conv kernels transposed to OIHW as params_from_jax gives them."""
    jparams = jax.device_get(jax_unet.init_unet_params(
        jax.random.PRNGKey(0), jax_unet.tiny_config(sdxl=sdxl)))
    pparams = port_unet.init_unet_params(torch.Generator().manual_seed(0),
                                         port_unet.tiny_config(sdxl=sdxl))
    assert _shapes(pparams) == _shapes(params_from_jax(jparams))


def test_params_from_jax_takes_bf16_trees():
    """A bf16 JAX tree (ml_dtypes leaves) converts to the same tensors as
    the float32 tree cast to bf16."""
    jparams = jax_unet.init_unet_params(jax.random.PRNGKey(2),
                                        jax_unet.tiny_config(sdxl=True))
    got = params_from_jax(jax.device_get(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)))
    want = port_unet.cast_params(params_from_jax(jax.device_get(jparams)),
                                 torch.bfloat16)
    flat_got = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    flat_want = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)


def test_attention_calls_per_forward_sdxl():
    """SDXL's 70 transformer blocks: 140 sdpa calls per UNet evaluation."""
    assert port_unet.attention_calls_per_forward(port_unet.sdxl_config()) == 140
    cfg = port_unet.tiny_config(sdxl=True)
    calls = []
    orig = port_unet.DenseDispatch

    class Counting(orig):
        def self_attn(self, *a, **k):
            calls.append("self")
            return super().self_attn(*a, **k)

        def cross_attn(self, *a, **k):
            calls.append("cross")
            return super().cross_attn(*a, **k)

    params = port_unet.init_unet_params(torch.Generator().manual_seed(0), cfg)
    port_unet.unet_forward(
        params, cfg, torch.zeros(1, 8, 8, 4), torch.tensor(10), torch.zeros(1, 4, 32),
        dispatch=Counting(),
        added_cond={"text_embeds": torch.zeros(1, 32), "time_ids": torch.zeros(1, 6)},
    )
    assert len(calls) == port_unet.attention_calls_per_forward(cfg)
