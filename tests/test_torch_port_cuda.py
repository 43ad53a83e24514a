"""PyTorch port: the CUDA kernels against their plain versions.

Needs a CUDA card (marker ``cuda``; each test skips without one).  The file
imports neither jax nor the JAX package, so it also runs where only the
port's dependencies are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Flash attention, in bf16: max |d| <= 2e-2 and mean |d| <= 2e-3 (a few bf16
roundings of outputs below 1); two calls on the same inputs are
bit-identical (no atomics, a fixed order of sums).  The log-sum-exp
instances: the same bound on their float32 output, lse within 1e-3.
Quantized matmul and per-token quantization: see their section.
"""

import pytest
import torch

from distrifuser_tpu_torch.ops import flash_attention as port_flash
from distrifuser_tpu_torch.ops import linear as port_linear
from distrifuser_tpu_torch.ops import quant_matmul as port_qmm
from distrifuser_tpu_torch.ops import quantize as port_quantize
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
     (2, 1000, 1000, 5, 64), (1, 200, 333, 3, 128), (1, 130, 257, 2, 256),
     (2, 4096, 4096, 8, 40), (2, 4096, 77, 8, 40), (2, 1024, 1024, 8, 80),
     (2, 1024, 77, 8, 80), (2, 256, 256, 8, 160), (2, 64, 77, 8, 160),
     (1, 100, 333, 3, 40), (1, 77, 200, 5, 80), (1, 130, 70, 3, 160)],
    ids=["unet_self", "text_cross_ragged", "vae_ragged", "tiny", "tiny_vae_d32",
         "unet_self_level2", "self_lq1000", "d128_ragged", "d256_ragged",
         "sd15_self_d40", "sd15_cross_d40", "sd15_self_d80", "sd15_cross_d80",
         "sd15_self_d160", "sd15_mid_cross_d160", "d40_ragged", "d80_ragged",
         "d160_ragged"],
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
@pytest.mark.parametrize("b,lq,lk,heads,d", [
    (1, 2048, 2048, 10, 64), (1, 512, 512, 20, 64), (2, 100, 333, 3, 40),
    (1, 77, 200, 5, 80), (1, 130, 70, 3, 160), (2, 64, 64, 4, 16),
    (1, 256, 256, 1, 32), (1, 200, 333, 3, 128), (1, 130, 257, 2, 256),
    (1, 300, 300, 1, 512), (1, 2048, 2048, 16, 72), (1, 100, 333, 3, 72),
    (2, 130, 257, 1, 72)],
    ids=["ring_l1", "ring_l2", "d40", "d80", "d160", "d16", "d32", "d128", "d256",
         "d512", "pixart_ring_d72", "d72_ragged_h3", "d72_ragged_h1"])
def test_lse_kernel_matches_reference_on_card(b, lq, lk, heads, d):
    """The log-sum-exp instances (``return_lse=True``): the float32 output
    and lse [B, H, Lq] against the plain version, every head dim; the
    output agrees with the bf16 instance's."""
    _need_card()
    q, k, v = _flash_operands(b, lq, lk, heads, d, seed=3)
    out, lse = port_flash.flash_sdpa(q, k, v, heads=heads, return_lse=True)
    want, want_lse = port_flash.flash_sdpa_reference(q, k, v, heads=heads,
                                                     return_lse=True)
    assert out.dtype == lse.dtype == torch.float32
    assert tuple(lse.shape) == (b, heads, lq)
    _assert_close(out, want)
    assert (lse - want_lse).abs().max().item() <= 1e-3
    _assert_close(out.bfloat16(), port_flash.flash_sdpa(q, k, v, heads=heads))
    masked, masked_lse = port_flash.flash_sdpa(q, k, v, heads=heads, kv_len=lk // 2 + 1,
                                               return_lse=True)
    want, want_lse = port_flash.flash_sdpa_reference(q, k, v, heads=heads,
                                                     kv_len=lk // 2 + 1, return_lse=True)
    _assert_close(masked, want)
    assert (masked_lse - want_lse).abs().max().item() <= 1e-3


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
    [(2, 1000, 1024, 4, 64, 700), (2, 512, 512, 4, 64, 129), (1, 256, 384, 1, 512, 150),
     (2, 300, 384, 8, 40, 150), (1, 200, 300, 2, 160, 65)],
    ids=["d64_strided_kv", "d64_one_past_tile", "d512", "d40", "d160"],
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
@pytest.mark.parametrize(
    "n,b,lq,heads",
    [(2, 1, 2048, 10), (2, 1, 512, 20), (4, 2, 1024, 10), (4, 2, 256, 20), (4, 1, 16, 4)],
    ids=["cfg2_sp2_l1", "cfg2_sp2_l2", "sp4_l1", "sp4_l2", "tiny_sp4"],
)
def test_kernel_at_patch_shapes_on_card(n, b, lq, heads):
    """The patch path's self-attention: this rank's L/n queries against the
    gathered KV [n, B, L/n, 2C] flattened in patch order and split into
    strided views (a view of the gathered buffer at B = 1), and its
    cross-attention against the 77 text tokens."""
    _need_card()
    from distrifuser_tpu_torch.ops.attention import _flatten_seq, split_kv

    d = 64 if lq > 16 else 16
    g = torch.Generator(device="cuda").manual_seed(n * lq)
    q = torch.randn(b, lq, heads * d, device="cuda", generator=g).bfloat16()
    gathered = torch.randn(n, b, lq, 2 * heads * d, device="cuda", generator=g).bfloat16()
    k, v = split_kv(_flatten_seq(gathered))
    assert k.shape == (b, n * lq, heads * d)
    if b == 1:
        assert k.untyped_storage().data_ptr() == gathered.untyped_storage().data_ptr()
    _assert_close(port_flash.flash_sdpa(q, k, v, heads=heads),
                  port_flash.flash_sdpa_reference(q, k, v, heads=heads))
    text_k, text_v = torch.randn(b, 77, 2 * heads * d, device="cuda",
                                 generator=g).bfloat16().chunk(2, dim=-1)
    _assert_close(port_flash.flash_sdpa(q, text_k, text_v, heads=heads),
                  port_flash.flash_sdpa_reference(q, text_k, text_v, heads=heads))


@pytest.mark.cuda
def test_kernel_d40_pad_columns_read_zeros_on_card():
    """d = 40 runs on 48 columns: q's 8 past each head must load as zeros,
    not as the next head's first 8, here 300 in q, k and v (read as q's pad
    columns they would swamp the logits); k's and v's pad columns, a
    neighbouring head's, must add nothing."""
    _need_card()
    q, k, v = _flash_operands(2, 256, 256, 8, 40, seed=4)
    for t in (q, k, v):
        t.unflatten(-1, (8, 40))[..., :8] = 300.0
    _assert_close(port_flash.flash_sdpa(q, k, v, heads=8),
                  port_flash.flash_sdpa_reference(q, k, v, heads=8))


@pytest.mark.cuda
def test_kernel_d40_shifted_heads_on_card():
    """A d = 40 head whose K columns start off a 32-byte boundary (every odd
    head) loads from 8 columns earlier: its Q pad columns are then the 8
    before the head and must load as zeros, not as the previous head's
    last 8, here 300 in q (k and v plain)."""
    _need_card()
    q, k, v = _flash_operands(2, 256, 256, 8, 40, seed=6)
    q.unflatten(-1, (8, 40))[..., -8:] = 300.0
    _assert_close(port_flash.flash_sdpa(q, k, v, heads=8),
                  port_flash.flash_sdpa_reference(q, k, v, heads=8))


@pytest.mark.cuda
def test_kernel_d40_separate_kv_on_card():
    """d = 40 with k and v separate tensors of exactly [B, Lk, C], as the VAE
    gives them: the last head's k and v pad columns lie past the last row
    of the allocation and must load as zeros, not be read."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(2, 200, 120, device="cuda", generator=g).bfloat16()
               for _ in range(3))
    _assert_close(port_flash.flash_sdpa(q, k, v, heads=3),
                  port_flash.flash_sdpa_reference(q, k, v, heads=3))


# PixArt-α's DiT: 16 heads of d = 72 (72 -> 96 columns, the d = 40 scheme)
D72_SHAPES = [(2, 4096, 4096, 16, 72), (1, 2048, 4096, 16, 72), (2, 1024, 1024, 16, 72),
              (1, 100, 333, 3, 72), (1, 130, 257, 1, 72), (2, 77, 64, 16, 72)]
D72_IDS = ["pixart_1024_dense", "pixart_1024_cfg2_sp2_rank", "pixart_512_dense",
           "ragged_h3", "ragged_h1", "short_kv"]


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lk,heads,d", D72_SHAPES, ids=D72_IDS)
def test_kernel_d72_on_card(b, lq, lk, heads, d):
    """The d = 72 instance at PixArt's shapes and ragged ones (Lq and Lk off
    the tiles, one head, three heads), with and without a kv_len mask that
    hides large rows of the fused KV."""
    _need_card()
    q, k, v = _flash_operands(b, lq, lk, heads, d, seed=7)
    _assert_close(port_flash.flash_sdpa(q, k, v, heads=heads),
                  port_flash.flash_sdpa_reference(q, k, v, heads=heads))
    kv_len = lk // 2 + 3
    k[:, kv_len:] = 300.0
    v[:, kv_len:] = -300.0
    _assert_close(port_flash.flash_sdpa(q, k, v, heads=heads, kv_len=kv_len),
                  port_flash.flash_sdpa_reference(q, k[:, :kv_len], v[:, :kv_len],
                                                  heads=heads))


@pytest.mark.cuda
@pytest.mark.parametrize("head", range(16))
def test_kernel_d72_every_head_on_card(head):
    """Each of PixArt's 16 heads alone: every other head's q, k and v hold
    300, so a box that read a neighbour's columns as Q's pad (an odd head
    loads from 8 columns earlier, every head up to 24 past its end) would
    swamp the logits; K's and V's pad columns, a neighbour's, must add
    nothing."""
    _need_card()
    q, k, v = _flash_operands(1, 256, 320, 16, 72, seed=8 + head)
    for t in (q, k, v):
        heads = t.unflatten(-1, (16, 72))
        keep = heads[..., head, :].clone()
        heads.fill_(300.0)
        heads[..., head, :] = keep
    got = port_flash.flash_sdpa(q, k, v, heads=16).unflatten(-1, (16, 72))[..., head, :]
    want = port_flash.flash_sdpa_reference(q, k, v, heads=16).unflatten(-1, (16, 72))
    _assert_close(got, want[..., head, :])


@pytest.mark.cuda
def test_kernel_d72_separate_kv_on_card():
    """d = 72 with k and v separate tensors of exactly [B, Lk, C]: the last
    head's pad columns lie past the allocation and must load as zeros."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn(2, 200, 3 * 72, device="cuda", generator=g).bfloat16()
               for _ in range(3))
    _assert_close(port_flash.flash_sdpa(q, k, v, heads=3),
                  port_flash.flash_sdpa_reference(q, k, v, heads=3))


@pytest.mark.cuda
def test_kernel_variants_fit_the_card():
    """Every head dim has an instance whose block fits one SM."""
    _need_card()
    for d in port_flash.HEAD_DIMS:
        for lse in (False, True):
            info = port_flash.variant(d, lse=lse)
            assert 0 < info["registers"] <= 255, (d, lse, info)
            assert info["smem_bytes"] <= 227 * 1024, (d, lse, info)


@pytest.mark.cuda
def test_kernel_wrapper_raises_instead_of_falling_back():
    _need_card()
    q = torch.randn(1, 128, 64, device="cuda")
    with pytest.raises(ValueError, match="bfloat16"):
        port_flash.flash_sdpa(q, q, q, heads=1)  # float32 on the card
    qb = q.bfloat16()
    with pytest.raises(ValueError, match="head dims"):
        port_flash.flash_sdpa(qb[..., :24], qb[..., :24], qb[..., :24], heads=1)
    q48 = torch.randn(1, 128, 96, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="head dims"):
        port_flash.flash_sdpa(q48, q48, q48, heads=2)  # d = 48
    with pytest.raises(ValueError, match="d=48"):
        port_flash.variant(48)


# ---------------------------------------------------------------------------
# quantized matmul (csrc/quant_matmul.cu): int8 bit-identical to the plain
# version in both forms; fp8 within 2e-3 * max |ref| in the fp32 contract
# form (the kernel sums e4m3 products in another order, below the bf16
# rounding its caller applies next) and within 8e-3 * max |ref|, one bf16
# ulp, in the fused bf16 form.  Per-token quantization
# (csrc/quantize_rows.cu): bit-identical to compress.quantize on the card.
# ---------------------------------------------------------------------------

FP8_REL = 2e-3
FP8_FUSED_REL = 8e-3
QUANT_SHAPES = [(64, 64, 48, 1), (33, 72, 50, 16), (128, 256, 130, 64), (2, 2816, 1280, 1),
                (154, 2048, 2560, 1), (8192, 640, 640, 1)]
QUANT_IDS = ["small", "ragged_k72", "ragged_n130", "temb_m2", "text_kv_m154", "level1"]


def _quant_operands(m, k, n, mode, channel_tile=1, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, device="cuda", generator=g)
    w = torch.randn(k, n, device="cuda", generator=g) / k**0.5
    xq, _ = quantize(x, mode)
    qt = quantize_weight(w, mode, channel_tile=channel_tile)
    return xq, qt.payload, qt.channel_scale()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("m,k,n,ct", QUANT_SHAPES, ids=QUANT_IDS)
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
    """K % 16 == 0 but xq starts one byte past a 16-byte boundary, which
    the tensor-memory accelerator cannot read: the wrapper must hand the
    kernel an aligned copy."""
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


def _fused_operands(m, k, n, mode, channel_tile=1, seed=0):
    """bf16 activation quantized per token (payload and sx), the weight
    payload, sw and a bf16 bias, as ops/linear.py hands them to the kernel."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, device="cuda", generator=g).bfloat16()
    w = (torch.randn(k, n, device="cuda", generator=g) / k**0.5).bfloat16()
    bias = torch.randn(n, device="cuda", generator=g).bfloat16()
    xq, sx = quantize(x, mode)
    qt = quantize_weight(w, mode, channel_tile=channel_tile)
    return xq, qt.payload, qt.channel_scale(), sx, bias


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("m,k,n,ct", QUANT_SHAPES, ids=QUANT_IDS)
def test_quant_kernel_fused_form_on_card(mode, with_bias, m, k, n, ct):
    """sx, the bf16 cast and the bias in the epilogue: the plain version's
    operations in the plain version's order.  fp8 with a bias is held bit
    for bit to the kernel's own output without it plus the bias: the cast
    and the add round twice, so a one-ulp difference from the plain version
    before the bias can become two after it."""
    _need_card()
    xq, wq, sw, sx, bias = _fused_operands(m, k, n, mode, ct, seed=1)
    bias = bias if with_bias else None
    before = port_qmm.quant_matmul.launches
    got = port_qmm.quant_matmul(xq, wq, sw, sx=sx, out_dtype=torch.bfloat16, bias=bias)
    torch.cuda.synchronize()
    assert port_qmm.quant_matmul.launches == before + 1
    want = port_qmm.quant_matmul_reference(xq, wq, sw, sx=sx, out_dtype=torch.bfloat16,
                                           bias=bias)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    if mode == "int8":
        assert torch.equal(got, want)
    elif with_bias:
        unbiased = port_qmm.quant_matmul(xq, wq, sw, sx=sx, out_dtype=torch.bfloat16)
        assert torch.equal(got, unbiased + bias)
    else:
        err = (got.float() - want.float()).abs().max().item()
        assert err <= FP8_FUSED_REL * want.float().abs().max().item(), err


def _quantize_inputs(m, k, seed):
    """bf16 rows: seeded values, an all-zero row, a row whose amax (127)
    makes the scale about 1 over half-integer values, and a row whose amax
    (254) makes odd integers land on half-way quotients."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(m, k, device="cuda", generator=g) * 3).bfloat16()
    x[0] = 0
    if m > 2:
        pattern = torch.tensor([127.0, 0.5, -1.5, 2.5, -3.5, 4.5, 0.0, -0.5])
        x[1] = pattern.repeat(-(-k // 8))[:k].bfloat16()
        x[2] = (torch.arange(k) % 9 * 2 - 7).float().clamp(-254, 254).bfloat16()
        x[2, 0] = 254.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("m,k", [(64, 72), (8192, 640), (3, 2816), (154, 2048)],
                         ids=["ragged_k72", "level1", "halfway_rows_m3", "text_m154"])
def test_quantize_rows_matches_quantize_on_card(mode, m, k):
    """The kernel is compress.quantize bit for bit on the card: payload
    bytes and scales."""
    _need_card()
    x = _quantize_inputs(m, k, seed=m + k)
    before = port_quantize.quantize_rows.launches
    xq, sx = port_quantize.quantize_rows(x, mode)
    torch.cuda.synchronize()
    assert port_quantize.quantize_rows.launches == before + 1
    want_q, want_s = quantize(x, mode, axis=-1)
    assert xq.dtype == want_q.dtype and xq.shape == (m, k) and sx.shape == (m,)
    assert torch.equal(xq.view(torch.uint8), want_q.view(torch.uint8))
    assert torch.equal(sx, want_s)
    assert sx[0].item() > 0 and not xq[0].view(torch.uint8).any()  # zero row: zeros


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quant_kernels_are_deterministic_on_card(mode):
    """Two calls of each kernel on the same inputs are bit-identical (no
    atomics, a fixed order of sums)."""
    _need_card()
    x = _quantize_inputs(2048, 1280, seed=5)
    q1, s1 = port_quantize.quantize_rows(x, mode)
    q2, s2 = port_quantize.quantize_rows(x, mode)
    assert torch.equal(q1.view(torch.uint8), q2.view(torch.uint8)) and torch.equal(s1, s2)
    _, wq, sw, _, bias = _fused_operands(2048, 1280, 2560, mode, seed=6)
    for kw in ({}, {"sx": s1, "out_dtype": torch.bfloat16, "bias": bias}):
        first = port_qmm.quant_matmul(q1, wq, sw, **kw)
        second = port_qmm.quant_matmul(q1, wq, sw, **kw)
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_quantize_rows_raises_instead_of_falling_back():
    """The kernel takes one tensor: a CUDA x of a type it has no instance
    for, or one that is not [M, K] with unit column stride, is refused; a
    CPU x runs the plain version, a tensor on another device is refused."""
    _need_card()
    x = torch.randn(8, 64, device="cuda")
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        port_quantize.quantize_rows(x.double(), "int8")
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        port_quantize.quantize_rows(x.half(), "fp8")
    with pytest.raises(ValueError, match="unit column stride"):
        port_quantize.quantize_rows(x.t(), "int8")
    with pytest.raises(ValueError, match="quantizing mode"):
        port_quantize.quantize_rows(x, "int4")
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_quantize.quantize_rows(x.to("meta"), "int8")
    before = port_quantize.quantize_rows.launches
    q_cpu, _ = port_quantize.quantize_rows(x.cpu(), "int8")
    assert q_cpu.device.type == "cpu" and port_quantize.quantize_rows.launches == before


@pytest.mark.cuda
def test_quant_fused_wrapper_refusals():
    """The fused form's extra operands are checked, not converted."""
    _need_card()
    xq, wq, sw, sx, bias = _fused_operands(64, 64, 48, "int8")
    with pytest.raises(ValueError, match="cpu"):
        port_qmm.quant_matmul(xq, wq, sw, sx=sx.cpu(), out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="sx must be"):
        port_qmm.quant_matmul(xq, wq, sw, sx=sx[:10], out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bias must be"):
        port_qmm.quant_matmul(xq, wq, sw, sx=sx, out_dtype=torch.bfloat16, bias=bias.float())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        port_qmm.quant_matmul(xq, wq, sw, sx=sx, out_dtype=torch.float16)


# ---------------------------------------------------------------------------
# the tiny SD pipeline: bf16 on the card against float32 on the CPU
# ---------------------------------------------------------------------------


def _tiny_sd_pipeline(device, dtype, scheduler, **fields):
    """An SD 1.5-shaped tiny pipeline (conv projections, head dims 40 and
    80, so the new instances run) from seeded weights, on ``device``."""
    from distrifuser_tpu_torch import DistriConfig, DistriSDPipeline
    from distrifuser_tpu_torch.models import clip, unet, vae
    from distrifuser_tpu_torch.models.unet import cast_params

    ucfg = unet.UNetConfig(
        block_out_channels=(80, 80, 160, 160),
        down_block_types=("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",),
        up_block_types=("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3,
        layers_per_block=1, transformer_layers_per_block=(1, 1, 1, 1),
        num_attention_heads=(2, 2, 2, 2), cross_attention_dim=32, norm_num_groups=8,
        use_linear_projection=False, addition_embed_type=None,
        projection_class_embeddings_input_dim=0)
    vcfg, tcfg = vae.tiny_vae_config(), clip.tiny_clip_config(hidden=32)
    gen = torch.Generator().manual_seed(0)
    u, v, t = (cast_params(x, dtype, device) for x in (
        unet.init_unet_params(gen, ucfg), vae.init_vae_params(gen, vcfg),
        clip.init_clip_params(gen, tcfg)))
    cfg = DistriConfig(device=device, height=128, width=128, **fields)
    return DistriSDPipeline.from_params(cfg, ucfg, u, vcfg, v, [tcfg], [t],
                                        scheduler=scheduler)


def _tiny_sd_latents(pipe):
    import numpy as np

    latents = np.random.RandomState(0).randn(1, 16, 16, 4).astype(np.float32)
    return pipe("a lighthouse", num_inference_steps=3, latents=latents,
                output_type="latent").images[0]


@pytest.mark.cuda
def test_tiny_sd_pipeline_on_card_matches_cpu():
    """The tiny SD 1.5-shaped pipeline in bf16 on the card against float32
    on the CPU, same weights and latents (Euler): relative L2 of the
    latents <= 8e-2, the bound of chip_smoke.py's tiny checks, and 20
    flash launches per UNet evaluation."""
    _need_card()
    import numpy as np

    from distrifuser_tpu_torch.models import unet

    ref = _tiny_sd_latents(_tiny_sd_pipeline("cpu", torch.float32, "euler"))
    pipe = _tiny_sd_pipeline("cuda", torch.bfloat16, "euler")
    port_flash.flash_sdpa.launches = 0
    got = _tiny_sd_latents(pipe)
    assert port_flash.flash_sdpa.launches == 3 * unet.attention_calls_per_forward(
        pipe.unet_config)
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 8e-2


@pytest.mark.cuda
@pytest.mark.parametrize("scheduler", ["euler", "dpm-solver"])
def test_tiny_sd_graphed_equals_eager_on_card(scheduler):
    """Under CUDA graphs the scheduler runs outside the captured UNet step:
    Euler's scaled input goes into the graph's static input at every step,
    nothing of it is captured, so the graphed latents equal the eager ones
    bit for bit."""
    _need_card()
    import numpy as np

    graphed = _tiny_sd_latents(_tiny_sd_pipeline("cuda", torch.bfloat16, scheduler))
    eager = _tiny_sd_latents(_tiny_sd_pipeline("cuda", torch.bfloat16, scheduler,
                                               use_cuda_graph=False))
    np.testing.assert_array_equal(graphed, eager)


# -- the refresh codec: quantize_rows (encode) and dequantize_rows (decode) --
#
# Both kernels are their plain versions (quantize_rows_reference,
# dequantize_rows_reference: the compositions of parallel/compress.py run on
# the card) bit for bit: payload bytes, scales and decoded buffers.


def _linear_shapes(ucfg, size):
    """Every (M, K) the quantized linears of a 4-step ``size``^2 call give
    the encoder: per UNet level with transformer blocks M = 2 x tokens
    (CFG folded) at K = C and 4C, the text KV (154 x cross dim), and the
    time and added embeddings on 2 rows."""
    from distrifuser_tpu_torch.models.unet import transformer_blocks_per_level

    lat = size // 8
    shapes = {(154, ucfg.cross_attention_dim), (2, ucfg.block_out_channels[0]),
              (2, ucfg.time_embed_dim)}
    if ucfg.addition_embed_type == "text_time":
        shapes.add((2, ucfg.projection_class_embeddings_input_dim))
    for lvl, blocks in enumerate(transformer_blocks_per_level(ucfg)):
        if blocks:
            c, m = ucfg.block_out_channels[lvl], 2 * (lat >> lvl) ** 2
            shapes |= {(m, c), (m, 4 * c)}
    return sorted(shapes)


def _refresh_segments(dtype, k, residual, seed=0):
    """One rank's refresh payloads of an SDXL 1024^2 stale step at CFG 2 x
    sp 2 (a superset of every shape compress_pcpp and stepcache_batch
    code): KV [1, L/2, 2C] at levels 1 and 2, and the halo slabs of
    [1, 64 >> l, 128 >> l, C] activations at every level for every halo
    channel count, with the residual base and the rotation r = 1 (a device
    scalar) where asked."""
    from distrifuser_tpu_torch.parallel.context import _halo_slabs

    g = torch.Generator(device="cuda").manual_seed(seed)
    every = (k, torch.tensor(1, device="cuda")) if k > 1 else None
    segs = []

    def rows(*shape):
        x = (torch.randn(*shape, device="cuda", generator=g) * 3).to(dtype)
        x.view(-1, shape[-1])[0] = 0
        return x

    for tokens, c in ((2048, 1280), (512, 2560)):
        x = rows(1, tokens, c)
        segs.append(port_quantize.EncodeSeg(x, rows(1, tokens, c) if residual else None,
                                            every))
    for lvl in range(3):
        for c in (320, 640, 960, 1280, 1920, 2560):
            x = rows(1, 64 >> lvl, 128 >> lvl, c)
            base = rows(2, 1, 1, 128 >> lvl, c) if residual else None
            segs.append(port_quantize.EncodeSeg(_halo_slabs(x, 1), base, every))
    return segs


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _decode_seg(enc_seg, q, s, dtype, seed):
    """The receiving side of an encoded segment: its payload decoded into a
    new buffer of the source's shape, against a seeded previous buffer."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    prev = torch.randn(enc_seg.x.shape, device="cuda", generator=g).to(dtype)
    return port_quantize.DecodeSeg(q, s, prev if enc_seg.base is not None else None,
                                   prev if enc_seg.every is not None else None,
                                   enc_seg.every)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("model", ["sdxl", "sd15"])
def test_codec_at_linear_shapes_on_card(mode, model):
    """At every quantized-linear (M, K) of SDXL 1024^2 and SD 1.5 512^2:
    the encoder is compress.quantize bit for bit and the decoder the plain
    dequantize-and-cast bit for bit."""
    _need_card()
    from distrifuser_tpu_torch.models import unet

    ucfg, size = (unet.sdxl_config(), 1024) if model == "sdxl" else (unet.sd15_config(), 512)
    for i, (m, k) in enumerate(_linear_shapes(ucfg, size)):
        x = _quantize_inputs(m, k, seed=i)
        xq, sx = port_quantize.quantize_rows(x, mode)
        want_q, want_s = quantize(x, mode)
        assert _same(xq, want_q) and _same(sx, want_s), (m, k)
        seg = port_quantize.DecodeSeg(xq, sx)
        got, = port_quantize.dequantize_rows_grouped([seg], torch.bfloat16)
        assert _same(got, port_quantize.dequantize_rows_reference(seg, torch.bfloat16)), (m, k)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8", "int8_residual"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_codec_at_refresh_payloads_on_card(mode, k, dtype):
    """At every refresh payload of the knob runs, bf16 and float32 sources,
    with the residual base and the rotation: each segment alone and the
    whole step's table in one grouped launch equal the plain versions bit
    for bit, encode and decode (the decode keeping the other rows of a
    partial refresh and adding the base)."""
    _need_card()
    payload = "int8" if mode == "int8_residual" else mode
    segs = _refresh_segments(dtype, k, mode == "int8_residual", seed=k)
    want = [port_quantize.quantize_rows_reference(seg, payload) for seg in segs]
    before = port_quantize.quantize_rows_grouped.launches
    grouped = port_quantize.quantize_rows_grouped(segs, payload)
    assert port_quantize.quantize_rows_grouped.launches == before + 1
    for seg, (q, s), (wq, ws) in zip(segs, grouped, want):
        assert _same(q, wq) and _same(s, ws), tuple(seg.x.shape)
        (q1, s1), = port_quantize.quantize_rows_grouped([seg], payload)
        assert _same(q1, wq) and _same(s1, ws), tuple(seg.x.shape)
    dsegs = [_decode_seg(seg, q, s, dtype, seed=i) for i, (seg, (q, s)) in
             enumerate(zip(segs, grouped))]
    before = port_quantize.dequantize_rows_grouped.launches
    bufs = port_quantize.dequantize_rows_grouped(dsegs, dtype)
    assert port_quantize.dequantize_rows_grouped.launches == before + 1
    for seg, buf in zip(dsegs, bufs):
        assert _same(buf, port_quantize.dequantize_rows_reference(seg, dtype))


@pytest.mark.cuda
def test_codec_tables_split_into_launches_on_card():
    """A table longer than CAPACITY segments runs in as many launches as it
    takes, and a table mixing bfloat16 and float32 sources in one launch per
    type, every segment bit for bit the plain version; the halves of a halo
    exchange in two separate receive buffers decode as two parts."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(3)
    cap = port_quantize.CAPACITY
    segs = [port_quantize.EncodeSeg(
        torch.randn(1 + i % 5, 8 * (1 + i % 7), device="cuda", generator=g).bfloat16(),
        None, (2, i % 2) if i % 5 % 2 == 1 else None) for i in range(2 * cap + 3)]
    # rows 1 + i % 5 is even where every is set: k = 2 divides them
    before = port_quantize.quantize_rows_grouped.launches
    got = port_quantize.quantize_rows_grouped(segs, "fp8")
    assert port_quantize.quantize_rows_grouped.launches == before + 3
    for seg, (q, s) in zip(segs, got):
        wq, ws = port_quantize.quantize_rows_reference(seg, "fp8")
        assert _same(q, wq) and _same(s, ws)
    dsegs = [port_quantize.DecodeSeg(q, s) for q, s in got]
    before = port_quantize.dequantize_rows_grouped.launches
    bufs = port_quantize.dequantize_rows_grouped(dsegs, torch.bfloat16)
    assert port_quantize.dequantize_rows_grouped.launches == before + 3
    for seg, buf in zip(dsegs, bufs):
        assert _same(buf, port_quantize.dequantize_rows_reference(seg, torch.bfloat16))
    # a table mixing source types runs one launch per kernel instance
    mixed = [port_quantize.EncodeSeg(seg.x.float() if i % 2 else seg.x, None, seg.every)
             for i, seg in enumerate(segs[:10])]
    before = port_quantize.quantize_rows_grouped.launches
    for seg, (q, s) in zip(mixed, port_quantize.quantize_rows_grouped(mixed, "int8")):
        wq, ws = port_quantize.quantize_rows_reference(seg, "int8")
        assert _same(q, wq) and _same(s, ws)
    assert port_quantize.quantize_rows_grouped.launches == before + 2
    q0, s0 = got[1]
    q1, s1 = q0.clone(), s0.clone()
    prev = torch.randn(2, *q0.shape, device="cuda", generator=g).bfloat16()
    seg = port_quantize.DecodeSeg([q0, q1], [s0, s1], prev)
    assert _same(port_quantize.dequantize_rows_grouped([seg], torch.bfloat16)[0],
                 port_quantize.dequantize_rows_reference(seg, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_codec_unstaged_rows_on_card(dtype):
    """Rows the encoder does not stage in shared memory: a column count
    that rules out 16-byte vectors (scalar two-pass loop) and rows with a
    base too wide for one warp's stages (vector two-pass loop), beside
    staged rows in one table; each bit for bit the plain version."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    every = (2, torch.tensor(1, device="cuda"))

    def rows(*shape):
        return (torch.randn(*shape, device="cuda", generator=g) * 3).to(dtype)

    segs = [port_quantize.EncodeSeg(rows(6, 13)),
            port_quantize.EncodeSeg(rows(4, 30000), rows(4, 30000), every),
            port_quantize.EncodeSeg(rows(64, 640), rows(64, 640), every)]
    for mode in ("int8", "fp8"):
        for seg, (q, s) in zip(segs, port_quantize.quantize_rows_grouped(segs, mode)):
            wq, ws = port_quantize.quantize_rows_reference(seg, mode)
            assert _same(q, wq) and _same(s, ws), (mode, tuple(seg.x.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_codec_narrow_path_layouts_on_card(dtype):
    """Tables the encoder's narrow path takes (at least 4096 rows of at
    most 640 bf16 or 320 float32 columns, no base) in layouts the quantized
    linears do not give it: several segments, a partial refresh with a
    device rotation, a halo's two slabs read in place; each segment bit for
    bit the plain version."""
    _need_card()
    from distrifuser_tpu_torch.parallel.context import _halo_slabs

    g = torch.Generator(device="cuda").manual_seed(6)

    def rows(*shape):
        return (torch.randn(*shape, device="cuda", generator=g) * 3).to(dtype)

    segs = [port_quantize.EncodeSeg(rows(2, 4096, 320), None,
                                    (2, torch.tensor(1, device="cuda"))),
            port_quantize.EncodeSeg(_halo_slabs(rows(2, 64, 32, 320), 1)),
            port_quantize.EncodeSeg(rows(3000, 160))]
    for mode in ("int8", "fp8"):
        for seg, (q, s) in zip(segs, port_quantize.quantize_rows_grouped(segs, mode)):
            wq, ws = port_quantize.quantize_rows_reference(seg, mode)
            assert _same(q, wq) and _same(s, ws), (mode, tuple(seg.x.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_rows_near_rounding_boundaries_on_card(mode):
    """Quotients on and within a few units in the last place of every
    rounding boundary of the payload (the half-integers for int8, the
    midpoints between e4m3 values for fp8), both signs, in float32 rows
    whose max makes the scale about 1: payload bytes and scales equal the
    plain version's."""
    _need_card()
    limit = 127.0 if mode == "int8" else 448.0
    if mode == "int8":
        bounds = torch.arange(-126.5, 127.0, 1.0, dtype=torch.float64)
    else:
        values = torch.arange(0, 127, dtype=torch.uint8).view(torch.float8_e4m3fn).double()
        mids = (values[1:] + values[:-1]) / 2
        bounds = torch.cat([mids, -mids])
    steps = torch.arange(-6, 7, dtype=torch.float64) * 2.0**-23
    q = (bounds[:, None] * (1 + steps[None, :])).flatten()
    q = torch.cat([q, torch.tensor([limit, 0.0, -0.0], dtype=torch.float64)])
    q = torch.cat([q, q.new_zeros(-len(q) % 8)]).float()
    rows = torch.stack([q, q.flip(0), q * 0.999, q * 1.001]).cuda()
    xq, sx = port_quantize.quantize_rows(rows, mode)
    want_q, want_s = quantize(rows, mode)
    assert _same(xq, want_q) and _same(sx, want_s)


@pytest.mark.cuda
def test_codec_rotation_changes_between_graph_replays_on_card():
    """One captured graph of an encode and a decode with the rotation r a
    device scalar: after r changes between two replays, each replay equals
    the plain versions at that r."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(4)
    r = torch.zeros((), dtype=torch.int64, device="cuda")
    x = torch.randn(1, 512, 2560, device="cuda", generator=g).bfloat16()
    base = torch.randn(1, 512, 2560, device="cuda", generator=g).bfloat16()
    prev = torch.randn(1, 512, 2560, device="cuda", generator=g).bfloat16()

    def step():
        (q, s), = port_quantize.quantize_rows_grouped(
            [port_quantize.EncodeSeg(x, base, (4, r))], "int8")
        out, = port_quantize.dequantize_rows_grouped(
            [port_quantize.DecodeSeg(q, s, prev, prev, (4, r))], torch.bfloat16)
        return q, s, out

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        q, s, out = step()
    for rot in (1, 3):
        r.fill_(rot)
        graph.replay()
        torch.cuda.synchronize()
        wq, ws = port_quantize.quantize_rows_reference(
            port_quantize.EncodeSeg(x, base, (4, rot)), "int8")
        want = port_quantize.dequantize_rows_reference(
            port_quantize.DecodeSeg(wq, ws, prev, prev, (4, rot)), torch.bfloat16)
        assert _same(q, wq) and _same(s, ws) and _same(out, want), rot


@pytest.mark.cuda
def test_codec_kernel_instances_fit_the_card():
    """Registers and spills of every instance (ptxas, read back through
    cudaFuncGetAttributes): no spills, and the full table within the 32,764
    bytes of kernel parameters."""
    _need_card()
    for kind in ("quantize", "dequantize"):
        for table in (1, 16, port_quantize.CAPACITY):
            for mode in ("int8", "fp8"):
                v = port_quantize.variant(kind, table, mode)
                print(kind, table, mode, v)
                assert v["spill_bytes"] == 0 and v["param_bytes"] <= 32764, (kind, table, v)


@pytest.mark.cuda
@pytest.mark.parametrize("b,cin,cout,h", [(4, 640, 640, 64), (4, 1280, 1280, 32),
                                          (2, 1280, 1280, 32), (2, 512, 512, 128)])
def test_conv_gives_each_image_what_it_alone_gets_on_card(b, cin, cout, h):
    """ops/conv.py convolves a batch one image a launch on the card: cuDNN's
    batched call gives an image bits that depend on its batch position at
    some of SDXL's shapes, which would make a served image depend on the
    requests it was coalesced with."""
    _need_card()
    from distrifuser_tpu_torch.ops.conv import conv2d

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(b, h, h, cin, device="cuda", generator=g).bfloat16()
    w = (torch.randn(cout, cin, 3, 3, device="cuda", generator=g) / (9 * cin) ** 0.5
         ).bfloat16().contiguous(memory_format=torch.channels_last)
    p = {"kernel": w, "bias": torch.randn(cout, device="cuda", generator=g).bfloat16()}
    y = conv2d(p, x)
    assert y.is_contiguous()
    for i in range(b):
        assert torch.equal(y[i:i + 1], conv2d(p, x[i:i + 1])), i
