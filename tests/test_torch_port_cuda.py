"""PyTorch port: the CUDA kernels against their plain versions.

Needs a CUDA card (marker ``cuda``; each test skips without one).  The file
imports neither jax nor the JAX package, so it also runs where only the
port's dependencies are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Flash attention, in bf16: max |d| <= 2e-2 and mean |d| <= 2e-3 (a few bf16
roundings of outputs below 1); two calls on the same inputs are
bit-identical (no atomics, a fixed order of sums).  Quantized matmul: see its section.
"""

import pytest
import torch

from distrifuser_tpu_torch.ops import flash_attention as port_flash
from distrifuser_tpu_torch.ops import linear as port_linear
from distrifuser_tpu_torch.ops import quant_matmul as port_qmm
from distrifuser_tpu_torch.parallel.compress import quantize, quantize_weight


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _flash_operands(b, lq, lk, heads, d, seed=0):
    """q [B, Lq, C] and k, v as strided views of one [B, Lk, 2C] tensor, as
    the fused to_kv projection gives them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = heads * d
    q = torch.randn(b, lq, c, device="cuda", generator=g).bfloat16()
    kv = torch.randn(b, lk, 2 * c, device="cuda", generator=g).bfloat16()
    k, v = kv.chunk(2, dim=-1)
    return q, k, v


def _assert_close(got, want):
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3, (
        err.max().item(), err.mean().item())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,lq,lk,heads,d",
    [(2, 4096, 4096, 10, 64), (2, 1000, 77, 20, 64), (1, 300, 300, 1, 512),
     (2, 64, 64, 4, 16), (1, 256, 256, 1, 32), (2, 1024, 1024, 20, 64),
     (2, 1000, 1000, 5, 64), (1, 200, 333, 3, 128), (1, 130, 257, 2, 256)],
    ids=["unet_self", "text_cross_ragged", "vae_ragged", "tiny", "tiny_vae_d32",
         "unet_self_level2", "self_lq1000", "d128_ragged", "d256_ragged"],
)
def test_kernel_matches_reference_on_card(b, lq, lk, heads, d):
    _need_card()
    q, k, v = _flash_operands(b, lq, lk, heads, d)
    before = port_flash.flash_sdpa.launches
    got = port_flash.flash_sdpa(q, k, v, heads=heads)
    torch.cuda.synchronize()
    assert port_flash.flash_sdpa.launches == before + 1
    _assert_close(got, port_flash.flash_sdpa_reference(q, k, v, heads=heads))


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
@pytest.mark.parametrize(
    "b,lq,lk,heads,d,kv_len",
    [(2, 1000, 1024, 4, 64, 700), (2, 512, 512, 4, 64, 129), (1, 256, 384, 1, 512, 150)],
    ids=["d64_strided_kv", "d64_one_past_tile", "d512"],
)
def test_kernel_kv_len_masks_real_rows_on_card(b, lq, lk, heads, d, kv_len):
    """Rows of the fused to_kv output between kv_len and Lk hold large
    values: they must be masked by logit, not read as keys."""
    _need_card()
    q, k, v = _flash_operands(b, lq, lk, heads, d, seed=2)
    k[:, kv_len:] = 300.0
    v[:, kv_len:] = -300.0
    got = port_flash.flash_sdpa(q, k, v, heads=heads, kv_len=kv_len)
    _assert_close(got, port_flash.flash_sdpa_reference(q, k, v, heads=heads,
                                                       kv_len=kv_len))
    trunc = port_flash.flash_sdpa_reference(q, k[:, :kv_len], v[:, :kv_len], heads=heads)
    _assert_close(got, trunc)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,heads,d", [(2, 1024, 1024, 20, 64), (1, 300, 300, 1, 512)],
                         ids=["d64", "d512"])
def test_kernel_is_deterministic_on_card(b, lq, lk, heads, d):
    _need_card()
    q, k, v = _flash_operands(b, lq, lk, heads, d, seed=3)
    first = port_flash.flash_sdpa(q, k, v, heads=heads)
    second = port_flash.flash_sdpa(q, k, v, heads=heads)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_kernel_variants_fit_the_card():
    """Every head dim has an instance whose block fits one SM."""
    _need_card()
    for d in port_flash.HEAD_DIMS:
        info = port_flash.variant(d)
        assert 0 < info["registers"] <= 255, (d, info)
        assert info["smem_bytes"] <= 227 * 1024, (d, info)


@pytest.mark.cuda
def test_kernel_wrapper_raises_instead_of_falling_back():
    _need_card()
    q = torch.randn(1, 128, 64, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        port_flash.flash_sdpa(q, q, q, heads=1)  # float32 on the card
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="head dims"):
        port_flash.flash_sdpa(qb[..., :40], qb[..., :40], qb[..., :40], heads=1)
    q48 = torch.randn(1, 128, 96, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="head dims"):
        port_flash.flash_sdpa(q48, q48, q48, heads=2)  # d = 48
    with pytest.raises(ValueError, match="d=48"):
        port_flash.variant(48)


# ---------------------------------------------------------------------------
# quantized matmul (csrc/quant_matmul.cu): int8 bit-identical to the plain
# version; fp8 within 2e-3 * max |ref| (the kernel sums e4m3 products in
# another order, below the bf16 rounding its caller applies next)
# ---------------------------------------------------------------------------

FP8_REL = 2e-3


def _quant_operands(m, k, n, mode, channel_tile=1, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, device="cuda", generator=g)
    w = torch.randn(k, n, device="cuda", generator=g) / k**0.5
    xq, _ = quantize(x, mode)
    qt = quantize_weight(w, mode, channel_tile=channel_tile)
    return xq, qt.payload, qt.channel_scale()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize(
    "m,k,n,ct",
    [(64, 64, 48, 1), (33, 72, 50, 16), (128, 256, 130, 64), (2, 2816, 1280, 1),
     (154, 2048, 2560, 1), (8192, 640, 640, 1)],
    ids=["small", "ragged_k72", "ragged_n130", "temb_m2", "text_kv_m154", "level1"],
)
def test_quant_kernel_matches_reference_on_card(mode, m, k, n, ct):
    _need_card()
    xq, wq, sw = _quant_operands(m, k, n, mode, ct)
    before = port_qmm.quant_matmul.launches
    got = port_qmm.quant_matmul(xq, wq, sw)
    torch.cuda.synchronize()
    assert port_qmm.quant_matmul.launches == before + 1
    want = port_qmm.quant_matmul_reference(xq, wq, sw)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    if mode == "int8":
        assert torch.equal(got, want)
    else:
        err = (got - want).abs().max().item()
        assert err <= FP8_REL * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quant_kernel_misaligned_operand_on_card(mode):
    """K % 16 == 0 but xq starts one byte past a 16-byte boundary: the
    kernel must stage byte by byte, not with 16-byte copies."""
    _need_card()
    m, k, n = 40, 64, 48
    xq, wq, sw = _quant_operands(m, k, n, mode)
    buf = torch.empty(m * k + 16, dtype=xq.dtype, device="cuda")
    shifted = buf[1:1 + m * k].view(m, k)
    shifted.copy_(xq)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    got = port_qmm.quant_matmul(shifted, wq, sw)
    want = port_qmm.quant_matmul_reference(xq, wq, sw)
    if mode == "int8":
        assert torch.equal(got, want)
    else:
        err = (got - want).abs().max().item()
        assert err <= FP8_REL * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quant_dot_route_matches_kernel_route_on_card(mode):
    """The library ("dot") and kernel ("pallas") routes of linear compute
    the same product, scales applied in another order."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(2, 77, 256, device="cuda", generator=g).bfloat16()
    w = (torch.randn(256, 384, device="cuda", generator=g) / 16).bfloat16()
    qt = quantize_weight(w, mode)
    dot = port_linear.linear({"kernel": qt.with_compute("dot")}, x)
    pal = port_linear.linear({"kernel": qt.with_compute("pallas")}, x)
    assert dot.dtype == pal.dtype == torch.bfloat16
    ref = x.float() @ qt.dense().float()
    assert (dot.float() - pal.float()).abs().max().item() <= 2e-2 * ref.abs().max().item()


@pytest.mark.cuda
def test_quant_wrapper_raises_instead_of_falling_back():
    _need_card()
    xq, wq, sw = _quant_operands(64, 64, 48, "int8")
    xf, wf, _ = _quant_operands(64, 64, 48, "fp8")
    with pytest.raises(ValueError, match="one type"):
        port_qmm.quant_matmul(xq, wf, sw)  # int8 @ fp8
    with pytest.raises(ValueError, match="float32"):
        port_qmm.quant_matmul(xq, wq, sw.bfloat16())
    with pytest.raises(ValueError, match="cpu"):
        port_qmm.quant_matmul(xq.cpu(), wq, sw)  # CPU activation, CUDA weight
    with pytest.raises(ValueError, match="column-major"):
        port_qmm.quant_matmul(xq, wq.contiguous(), sw)  # row-major [K, N]
