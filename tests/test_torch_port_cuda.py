"""PyTorch port: the CUDA flash-attention kernel against its plain version.

Needs a CUDA card (marker ``cuda``; each test skips without one).  The file
imports neither jax nor the JAX package, so it also runs where only the
port's dependencies are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Tolerance in bf16: max |d| <= 2e-2 and mean |d| <= 2e-3 (a few bf16
roundings of outputs below 1).
"""

import pytest
import torch

from distrifuser_tpu_torch.ops import flash_attention as port_flash


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,lq,lk,heads,d",
    [(2, 4096, 4096, 10, 64), (2, 1000, 77, 20, 64), (1, 300, 300, 1, 512),
     (2, 64, 64, 4, 16)],
    ids=["unet_self", "text_cross_ragged", "vae_ragged", "tiny"],
)
def test_kernel_matches_reference_on_card(b, lq, lk, heads, d):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    c = heads * d
    q = torch.randn(b, lq, c, device="cuda", generator=g).bfloat16()
    kv = torch.randn(b, lk, 2 * c, device="cuda", generator=g).bfloat16()
    k, v = kv.chunk(2, dim=-1)  # strided views, as the fused to_kv gives them
    before = port_flash.flash_sdpa.launches
    got = port_flash.flash_sdpa(q, k, v, heads=heads)
    torch.cuda.synchronize()
    assert port_flash.flash_sdpa.launches == before + 1
    want = port_flash.flash_sdpa_reference(q, k, v, heads=heads)
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3


@pytest.mark.cuda
def test_kernel_kv_len_mask_on_card():
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(1, 256, 128, device="cuda", generator=g).bfloat16()
               for _ in range(3))
    got = port_flash.flash_sdpa(q, k, v, heads=2, kv_len=200)
    want = port_flash.flash_sdpa_reference(q, k[:, :200], v[:, :200], heads=2)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_kernel_wrapper_raises_instead_of_falling_back():
    _need_card()
    q = torch.randn(1, 128, 64, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        port_flash.flash_sdpa(q, q, q, heads=1)  # float32 on the card
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="multiples of 16"):
        port_flash.flash_sdpa(qb[..., :40], qb[..., :40], qb[..., :40], heads=1)
