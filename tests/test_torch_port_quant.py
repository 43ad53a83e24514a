"""PyTorch port: weight quantization, the quantized matmul and its routing
against the JAX package, on the CPU.

The same numpy inputs go through the JAX functions and the port's.
Tolerances:

* payloads and scales of ``quantize``/``quantize_weight``: bit-identical
  (fp8 compared as bytes), and ``dense()`` equal to JAX's dequantization;
* ``quant_matmul_reference`` against JAX ``quant_matmul`` in interpret
  mode: int8 exactly equal; fp8 within 1e-6 * max |ref| (the same e4m3
  products summed in another order; 1.4e-7 relative measured);
* its fused form (``sx``, bfloat16 out, bias) against the JAX
  ``_quantized_matmul`` "pallas" route and ``linear`` in bfloat16, Pallas
  kernel in interpret mode: int8 bit-identical; fp8 within 8e-3 * max
  |ref|, one bfloat16 ulp (float32 sums that agree to 1e-6 can round to
  neighbouring bfloat16 values);
* ``ops/quantize.quantize_rows`` on the CPU: JAX ``quantize`` bit for bit;
* ``linear`` on a quantized leaf: the "pallas" and "dot" routes within
  1e-6 * max |y| (int8 measured exact), "dequant" within 1e-5 * max |y|
  (a float32 product of the same dense kernel).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrifuser_tpu.models import unet as jax_unet
from distrifuser_tpu.models import weights as jax_weights
from distrifuser_tpu.ops.quant_matmul import quant_matmul as jax_quant_matmul
from distrifuser_tpu.parallel import compress as jax_compress
from distrifuser_tpu_torch import DistriConfig
from distrifuser_tpu_torch.models import unet as port_unet
from distrifuser_tpu_torch.models import weights as port_weights
from distrifuser_tpu_torch.ops.gemm_routing import DOT_MIN_M, resolve
from distrifuser_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_reference
from distrifuser_tpu_torch.ops.quantize import quantize_rows
from distrifuser_tpu_torch.parallel import compress as port_compress

# ops/__init__ of the JAX package re-exports ``linear`` the function
jax_linear = importlib.import_module("distrifuser_tpu.ops.linear")
port_linear = importlib.import_module("distrifuser_tpu_torch.ops.linear")

MODES = ["int8", "fp8"]
MATMUL_SHAPES = [(64, 64, 48, 1), (33, 72, 50, 16), (128, 256, 130, 64)]


def _bytes(a):
    """Payload bytes of a numpy array or a tensor (fp8 as uint8)."""
    if isinstance(a, torch.Tensor):
        t = a.contiguous()
        return (t.view(torch.uint8) if t.element_size() == 1 else t).numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _port_layout(payload, scale):
    """A port conv payload/scale (OIHW, [O, kh, kw]) back in JAX's HWIO
    layout; linear ones unchanged."""
    if payload.dim() == 4:
        return payload.permute(2, 3, 1, 0), scale.permute(1, 2, 0)
    return payload, scale


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ct", [1, 16])
@pytest.mark.parametrize("shape", [(72, 50), (3, 3, 24, 40)], ids=["linear", "conv3x3"])
def test_quantize_weight_matches_jax_bitwise(mode, ct, shape):
    """50 and 40 output channels: the last 16-channel tile is partial."""
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = jax_compress.quantize_weight(jnp.asarray(w), mode, channel_tile=ct)
    tw = torch.from_numpy(w)
    got = port_compress.quantize_weight(tw.permute(3, 2, 0, 1) if tw.dim() == 4 else tw,
                                        mode, channel_tile=ct)
    assert got.channel_tile == ct and got.compute == "dequant"
    payload, scale = _port_layout(got.payload, got.scale)
    np.testing.assert_array_equal(_bytes(payload), _bytes(want.payload))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want.scale))
    dense, _ = _port_layout(got.dense(), got.scale)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(want.__jax_array__()))
    if len(shape) == 2:  # held column-major, the kernel's operand layout
        assert got.payload.stride() == (1, shape[0])
        assert tuple(got.shape) == shape
    assert got.nbytes == want.nbytes


@pytest.mark.parametrize("mode", MODES)
def test_activation_quantize_matches_jax_bitwise(mode):
    x = np.random.RandomState(1).randn(2, 9, 40).astype(np.float32)
    x[0, 3] = 0.0  # an all-zero row: scale floor, exact zeros
    qj, sj = jax_compress.quantize(jnp.asarray(x), mode, axis=-1)
    qp, sp = port_compress.quantize(torch.from_numpy(x), mode, axis=-1)
    np.testing.assert_array_equal(_bytes(qp), _bytes(qj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    back = port_compress.dequantize(qp, sp, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_compress.dequantize(qj, sj, jnp.float32)))


def test_quantized_tensor_refuses_misaligned_scale():
    w = torch.from_numpy(np.random.RandomState(5).randn(32, 50).astype(np.float32))
    qt = port_compress.quantize_weight(w, "int8", channel_tile=16)
    assert tuple(qt.scale.shape) == (4,)  # ceil(50 / 16)
    with pytest.raises(ValueError, match="misalignment"):
        port_compress.QuantizedTensor(qt.payload, qt.scale, qt.dtype)
    with pytest.raises(ValueError, match="compute policy"):
        port_compress.QuantizedTensor(qt.payload, qt.scale, qt.dtype, "bogus", 16)
    conv = port_compress.quantize_weight(torch.randn(40, 8, 3, 3), "fp8", channel_tile=16)
    assert tuple(conv.scale.shape) == (3, 3, 3)  # [ceil(40 / 16), kh, kw]
    with pytest.raises(ValueError, match="misalignment"):
        port_compress.QuantizedTensor(conv.payload, conv.scale, conv.dtype)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,k,n,ct", MATMUL_SHAPES)
def test_quant_matmul_reference_matches_jax_interpret(mode, m, k, n, ct):
    r = np.random.RandomState(3)
    w = r.randn(k, n).astype(np.float32)
    x = r.randn(m, k).astype(np.float32)
    jq = jax_compress.quantize_weight(jnp.asarray(w), mode, channel_tile=ct)
    jxq, _ = jax_compress.quantize(jnp.asarray(x), mode)
    want = np.asarray(jax_quant_matmul(jxq, jq.payload, jq.channel_scale(), interpret=True))
    pq = port_compress.quantize_weight(torch.from_numpy(w), mode, channel_tile=ct)
    pxq, _ = port_compress.quantize(torch.from_numpy(x), mode)
    before = quant_matmul.launches
    got = quant_matmul(pxq, pq.payload, pq.channel_scale())  # CPU: plain version
    assert quant_matmul.launches == before  # no kernel launched on the CPU
    np.testing.assert_array_equal(
        quant_matmul_reference(pxq, pq.payload, pq.channel_scale()).numpy(), got.numpy())
    if mode == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def _bf16_operands(m, k, n, mode, ct, seed):
    """bfloat16 x [m, k] and a JAX-quantized bfloat16 [k, n] leaf ("pallas"),
    with the port's copies: the same values, the same payload bytes."""
    r = np.random.RandomState(seed)
    xb = jnp.asarray(r.randn(m, k).astype(np.float32), dtype=jnp.bfloat16)
    wb = jnp.asarray(r.randn(k, n).astype(np.float32), dtype=jnp.bfloat16)
    bias = jnp.asarray(r.randn(n).astype(np.float32), dtype=jnp.bfloat16)
    jq = jax_compress.quantize_weight(wb, mode, compute="pallas", channel_tile=ct)
    pp = port_weights.params_from_jax({"kernel": jax.device_get(jq)})
    px = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    pb = torch.from_numpy(np.array(bias.astype(jnp.float32))).bfloat16()
    return xb, jq, bias, px, pp["kernel"], pb


def _assert_bf16_match(got, want, mode):
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if mode == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=8e-3 * np.abs(want).max())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,k,n,ct", MATMUL_SHAPES)
def test_fused_reference_matches_jax_pallas_route(mode, m, k, n, ct):
    """The plain fused form on the port's quantized activation equals JAX's
    "pallas" route (interpret mode) on the same payloads, in bfloat16."""
    xb, jq, _, px, pq, _ = _bf16_operands(m, k, n, mode, ct, seed=11)
    want = jax_linear._quantized_matmul(xb, jq)
    assert want.dtype == jnp.bfloat16
    pxq, sx = quantize_rows(px, mode)
    got = quant_matmul_reference(pxq, pq.payload, pq.channel_scale(), sx=sx,
                                 out_dtype=torch.bfloat16)
    _assert_bf16_match(got, want, mode)
    before = quant_matmul.launches
    same = quant_matmul(pxq, pq.payload, pq.channel_scale(), sx=sx, out_dtype=torch.bfloat16)
    assert quant_matmul.launches == before and torch.equal(same, got)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,k,n,ct", MATMUL_SHAPES[:2])
def test_linear_pallas_route_with_bias_matches_jax_in_bf16(mode, m, k, n, ct):
    """linear on a "pallas" leaf with a bfloat16 bias (the bias the kernel's
    epilogue adds on the card) against JAX's linear, on [2, m, k]."""
    xb, jq, bias, px, pq, pb = _bf16_operands(m, k, n, mode, ct, seed=12)
    want = jax_linear.linear({"kernel": jq, "bias": bias}, xb)
    got = port_linear.linear({"kernel": pq, "bias": pb}, px)
    _assert_bf16_match(got, want, mode)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_rows_on_cpu_is_jax_quantize(mode):
    """On the CPU the kernel's wrapper runs the plain version: JAX's
    quantize bit for bit, on bfloat16 rows with an all-zero row and a row
    of half-way quotients, and no launch counted."""
    x = np.random.RandomState(4).randn(6, 72).astype(np.float32)
    x[2] = 0.0
    x[3] = np.tile([127.0, 0.5, -1.5, 2.5], 18)
    xb = jnp.asarray(x, dtype=jnp.bfloat16)
    qj, sj = jax_compress.quantize(xb, mode, axis=-1)
    before = quantize_rows.launches
    qp, sp = quantize_rows(torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(),
                           mode)
    assert quantize_rows.launches == before
    np.testing.assert_array_equal(_bytes(qp), _bytes(qj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    with pytest.raises(ValueError, match="M, K"):
        quantize_rows(torch.zeros(2, 3, 4), mode)


def test_quant_matmul_shape_checks():
    xq = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="2D"):
        quant_matmul(xq[None], torch.zeros(8, 3, dtype=torch.int8), torch.ones(3))
    with pytest.raises(ValueError, match="shape mismatch"):
        quant_matmul(xq, torch.zeros(6, 3, dtype=torch.int8), torch.ones(3))
    with pytest.raises(ValueError, match="shape mismatch"):
        quant_matmul(xq, torch.zeros(8, 3, dtype=torch.int8), torch.ones(4))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("route", ["dequant", "dot", "pallas"])
@pytest.mark.parametrize("m,k,n,ct", MATMUL_SHAPES[:2])
def test_linear_routes_match_jax(mode, route, m, k, n, ct):
    """The same JAX-quantized leaf, through params_from_jax, on the same
    activation ([2, m, k] with a bias), per route."""
    r = np.random.RandomState(7)
    w = r.randn(k, n).astype(np.float32)
    x = r.randn(2, m, k).astype(np.float32)
    bias = r.randn(n).astype(np.float32)
    jq = jax_compress.quantize_weight(jnp.asarray(w), mode, compute=route,
                                      channel_tile=ct)
    want = np.asarray(jax_linear.linear({"kernel": jq, "bias": jnp.asarray(bias)},
                                        jnp.asarray(x)))
    pp = port_weights.params_from_jax({"kernel": jax.device_get(jq), "bias": bias})
    assert isinstance(pp["kernel"], port_compress.QuantizedTensor)
    assert pp["kernel"].compute == route
    got = port_linear.linear(pp, torch.from_numpy(x)).numpy()
    tol = (1e-5 if route == "dequant" else 1e-6) * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_resolve_forced_policies_and_analytic_default():
    for platform in ("cpu", "cuda"):
        for m in (2, 4096):
            assert resolve("int8", m, 64, 64, "dequant", platform=platform).impl == "dequant"
            assert resolve("int8", m, 64, 64, "dot", platform=platform).impl == "dot"
            assert resolve("fp8", m, 64, 64, "pallas", platform=platform).impl == "pallas"
    assert resolve("int8", 4096, 64, 64, "auto", platform="cpu").impl == "dequant"
    assert resolve("int8", DOT_MIN_M, 64, 64, "auto", platform="cuda").impl == "dot"
    assert resolve("fp8", DOT_MIN_M - 1, 64, 64, "auto", platform="cuda").impl == "dequant"
    assert resolve("int8", 2, 64, 64, "auto", platform="cuda").impl == "dequant"
    with pytest.raises(ValueError, match="unknown quantized-compute policy"):
        resolve("int8", 64, 64, 64, "fast", platform="cuda")


def test_validate_quant_compute_and_config_refusals():
    for p in ("off", "auto", "dot", "pallas"):
        port_compress.validate_quant_compute(p, "int8")
    port_compress.validate_quant_compute("auto", "none")
    port_compress.validate_quant_compute("off", "none")
    with pytest.raises(ValueError, match="quant_compute must be"):
        port_compress.validate_quant_compute("bogus", "int8")
    for p in ("dot", "pallas"):
        with pytest.raises(ValueError, match="no quantized kernels"):
            port_compress.validate_quant_compute(p, "none")
        with pytest.raises(ValueError, match="no quantized kernels"):
            DistriConfig(device="cpu", quant_compute=p)
    with pytest.raises(ValueError, match="tensor"):
        DistriConfig(device="cpu", weight_quant="int8", parallelism="tensor")
    with pytest.raises(ValueError, match="weight_quant must be"):
        DistriConfig(device="cpu", weight_quant="int4")
    with pytest.raises(ValueError, match="weight_quant must be"):
        DistriConfig(device="cpu", weight_quant_aux="int8_residual")
    cfg = DistriConfig(device="cpu", weight_quant="fp8", weight_quant_aux="int8",
                       quant_compute="pallas")
    assert (cfg.weight_quant, cfg.weight_quant_aux, cfg.quant_compute) == (
        "fp8", "int8", "pallas")
    assert DistriConfig(device="cpu").quant_compute == "auto"


# ---------------------------------------------------------------------------
# quantized trees
# ---------------------------------------------------------------------------


def _jax_tree(sdxl=True, seed=0):
    cfg = jax_unet.tiny_config(cross_attention_dim=32, sdxl=sdxl)
    return jax.device_get(jax_unet.init_unet_params(jax.random.PRNGKey(seed), cfg))


def _flat(tree, path=""):
    """{path: leaf} of a nested dict/list tree, QuantizedTensors as leaves."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{path}/{i}").items()}
    return {path: tree}


def _quantized_paths(tree):
    return sorted(p for p, leaf in _flat(tree).items()
                  if hasattr(leaf, "payload") and hasattr(leaf, "channel_tile"))


@pytest.mark.parametrize("mode", MODES)
def test_quantize_params_quantizes_jax_leaves(mode):
    jtree = _jax_tree()
    jq = jax_weights.quantize_params(jtree, mode, compute="pallas")
    pq = port_weights.quantize_params(port_weights.params_from_jax(jtree), mode,
                                      compute="pallas")
    assert _quantized_paths(pq) == _quantized_paths(jq)
    assert "/conv_out/kernel" not in _quantized_paths(pq)  # the dense head
    assert isinstance(pq["conv_out"]["kernel"], torch.Tensor)
    assert all(leaf.compute == "pallas" for p, leaf in _flat(pq).items()
               if p in _quantized_paths(pq))
    assert port_weights.params_nbytes(pq) == jax_weights.params_nbytes(jq)
    assert port_weights.params_nbytes(port_weights.params_from_jax(jtree)) == \
        jax_weights.params_nbytes(jtree)


@pytest.mark.parametrize("mode", MODES)
def test_params_from_jax_quantized_tree_equals_port_quantize(mode):
    """Converting a JAX-quantized tree gives, leaf for leaf, what the port's
    quantize_params makes of the converted dense tree."""
    jtree = _jax_tree()
    a = port_weights.params_from_jax(jax.device_get(
        jax_weights.quantize_params(jtree, mode, compute="dot", channel_tile=16)))
    b = port_weights.quantize_params(port_weights.params_from_jax(jtree), mode,
                                     compute="dot", channel_tile=16)
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for path in fa:
        x, y = fa[path], fb[path]
        assert type(x) is type(y), path
        if isinstance(x, port_compress.QuantizedTensor):
            assert (x.dtype, x.compute, x.channel_tile) == (y.dtype, y.compute, y.channel_tile)
            if x.ndim == 2:
                assert x.payload.stride() == y.payload.stride(), path
            np.testing.assert_array_equal(_bytes(x.payload), _bytes(y.payload))
            np.testing.assert_array_equal(x.scale.numpy(), y.scale.numpy())
        else:
            assert torch.equal(x, y), path


def test_quantize_params_retags_and_refuses():
    tree = port_weights.params_from_jax(_jax_tree())
    q = port_weights.quantize_params(tree, "int8", compute="dequant")
    kern = q["down_blocks"][1]["attentions"][0]["proj_in"]["kernel"]
    again = port_weights.quantize_params(q, "int8", compute="auto")
    kern2 = again["down_blocks"][1]["attentions"][0]["proj_in"]["kernel"]
    assert kern2.compute == "auto" and kern.compute == "dequant"
    assert kern2.payload is kern.payload and kern2.scale is kern.scale
    with pytest.raises(ValueError, match="already quantized"):
        port_weights.quantize_params(q, "fp8")
    with pytest.raises(ValueError, match="already-quantized"):
        port_weights.quantize_params(q, "none")
    assert port_weights.quantize_params(tree, "none") is tree
    with pytest.raises(ValueError, match="weight_quant must be"):
        port_weights.quantize_params(tree, "int4")


def test_set_quant_compute_retags_without_touching_payloads():
    q = port_weights.quantize_params(port_weights.params_from_jax(_jax_tree()), "int8")
    q2 = port_weights.set_quant_compute(q, "pallas")
    a = q["time_embedding"]["linear_1"]["kernel"]
    b = q2["time_embedding"]["linear_1"]["kernel"]
    assert a.compute == "dequant" and b.compute == "pallas"
    assert b.payload is a.payload and b.scale is a.scale
    q3 = port_weights.set_quant_compute(q2, "off")
    assert q3["time_embedding"]["linear_1"]["kernel"].compute == "dequant"
    with pytest.raises(ValueError, match="quant_compute"):
        port_weights.set_quant_compute(q, "int8")
    dense = port_weights.params_from_jax(_jax_tree())
    assert _flat(port_weights.set_quant_compute(dense, "dot")).keys() == _flat(dense).keys()


@pytest.mark.parametrize("mode", MODES)
def test_dequantize_params_matches_jax(mode):
    jtree = _jax_tree(sdxl=False)
    jq = jax_weights.quantize_params(jtree, mode)
    want = port_weights.params_from_jax(jax.device_get(jax_weights.dequantize_params(jq)))
    got = port_weights.dequantize_params(port_weights.params_from_jax(jax.device_get(jq)))
    fw, fg = _flat(want), _flat(got)
    assert fw.keys() == fg.keys()
    for path in fw:
        assert isinstance(fg[path], torch.Tensor)
        np.testing.assert_array_equal(fg[path].numpy(), fw[path].numpy(), err_msg=path)


@pytest.mark.parametrize("mode", MODES)
def test_cast_params_keeps_payloads_bit_for_bit(mode):
    q = port_weights.quantize_params(port_weights.params_from_jax(_jax_tree()), mode)
    cast = port_unet.cast_params(q, torch.bfloat16, "cpu")
    fq, fc = _flat(q), _flat(cast)
    n_quant = 0
    for path, leaf in fq.items():
        if isinstance(leaf, port_compress.QuantizedTensor):
            n_quant += 1
            got = fc[path]
            assert got.dtype == torch.bfloat16 and got.payload.dtype == leaf.payload.dtype
            assert got.scale.dtype == torch.float32
            assert got.payload.stride() == leaf.payload.stride()
            np.testing.assert_array_equal(_bytes(got.payload), _bytes(leaf.payload))
            assert torch.equal(got.scale, leaf.scale)
        else:
            assert fc[path].dtype == torch.bfloat16
    assert n_quant == len(_quantized_paths(q)) > 0


def test_linear_calls_match_a_counted_forward():
    """linear_calls(cfg): the quantized linears one forward runs, and the
    cross-attention to_kv ones precompute_text_kv runs."""
    assert port_unet.linear_calls(port_unet.sdxl_config()) == (533, 70)
    cfg = port_unet.tiny_config(cross_attention_dim=32, sdxl=True)
    params = port_weights.quantize_params(
        port_unet.init_unet_params(torch.Generator().manual_seed(0), cfg), "int8",
        compute="pallas")
    calls = []
    orig = port_linear.quant_matmul

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    port_linear.quant_matmul = counting
    try:
        enc = torch.zeros(2, 4, 32)
        kv = port_unet.precompute_text_kv(params, enc)
        n_kv = len(calls)
        port_unet.unet_forward(
            params, cfg, torch.zeros(2, 8, 8, 4), torch.tensor(10), enc,
            dispatch=port_unet.DenseDispatch(text_kv=kv),
            added_cond={"text_embeds": torch.zeros(2, 32), "time_ids": torch.zeros(2, 6)},
        )
    finally:
        port_linear.quant_matmul = orig
    assert (len(calls) - n_kv, n_kv) == port_unet.linear_calls(cfg)
