"""PyTorch port: flash attention against the JAX package.

The port's plain version (the kernel's CPU counterpart) is held against the
Pallas kernel run in interpret mode and against the JAX ``sdpa`` CPU route,
in float32 at rtol 1e-4, atol 1e-5 (sum-order differences only), at
every head dim a configuration gives the kernel, SD 1.x's 40, 80 and 160
included.  The
CUDA kernel itself is compared with the plain version on the card in
tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from distrifuser_tpu.ops.attention import sdpa as jax_sdpa
from distrifuser_tpu.ops.flash_attention import flash_sdpa as jax_flash_sdpa
from distrifuser_tpu_torch.ops import attention as port_attention
from distrifuser_tpu_torch.ops import flash_attention as port_flash

RTOL, ATOL = 1e-4, 1e-5


def _qkv(seed, b, lq, lk, c):
    r = np.random.RandomState(seed)
    return (r.randn(b, lq, c).astype(np.float32),
            r.randn(b, lk, c).astype(np.float32),
            r.randn(b, lk, c).astype(np.float32))


@pytest.mark.parametrize(
    "b,lq,lk,heads,d",
    [(2, 128, 256, 2, 64), (1, 128, 128, 1, 512), (2, 128, 128, 4, 16),
     (1, 128, 256, 1, 32), (2, 128, 256, 8, 40), (2, 128, 128, 8, 80),
     (1, 128, 128, 8, 160)],
    ids=["unet_d64", "vae_d512", "tiny_unet_d16", "tiny_vae_d32", "sd15_d40",
         "sd15_d80", "sd15_d160"],
)
def test_reference_matches_pallas_interpret(b, lq, lk, heads, d):
    q, k, v = _qkv(0, b, lq, lk, heads * d)
    want = jax_flash_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          heads=heads, interpret=True)
    got = port_flash.flash_sdpa(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), heads=heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _kv_len_case(heads, d):
    q, k, v = _qkv(1, 2, 128, 256, heads * d)
    want = jax_flash_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          heads=heads, interpret=True, kv_len=200)
    got = port_flash.flash_sdpa(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), heads=heads, kv_len=200)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # the mask equals truncating KV to its real length
    trunc = port_flash.flash_sdpa_reference(
        torch.from_numpy(q), torch.from_numpy(k[:, :200]),
        torch.from_numpy(v[:, :200]), heads=heads)
    np.testing.assert_allclose(got.numpy(), trunc.numpy(), rtol=RTOL, atol=ATOL)


def test_reference_kv_len_mask_matches_pallas_interpret():
    _kv_len_case(2, 64)


def test_reference_kv_len_mask_sd15_d40_matches_pallas_interpret():
    _kv_len_case(8, 40)


def test_ragged_text_kv_matches_jax_sdpa():
    """Cross-attention shape: 77 text tokens, ragged query length."""
    q, k, v = _qkv(2, 2, 100, 77, 128)
    want = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=2)
    got = port_attention.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), heads=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_cpu_wrapper_launches_no_kernel():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 16, 16, 32))
    before = port_flash.flash_sdpa.launches
    port_flash.flash_sdpa(q, k, v, heads=2)
    assert port_flash.flash_sdpa.launches == before
