"""PyTorch port: ring attention against the JAX package at the same n.

* ``flash_sdpa_reference(return_lse=True)``, the plain version of the flash
  kernel's log-sum-exp instances: the float32 output and ``lse`` against a
  float64 softmax and log-sum-exp, with and without a ``kv_len`` mask; and
  ``merge_partials`` of two halves of the KV equals the whole;
* ``ring_pass`` at 2 and 4 gloo ranks on identical chunks (with and without
  a static block) against the JAX ``ring_pass``; ``ring_self_attention``
  synchronous against the dense attention and the JAX ring, stale against
  the gather layout's stale output (within 2e-4, as
  tests/test_ring_attention.py pins) and the JAX ring, with a buffer n
  times smaller than the gathered one;
* the tiny SDXL runner with ``attn_impl="ring"`` at world 2 (sp 2) and 4
  (CFG 2 x sp 2) against the JAX ring run within 2e-4, its per-phase
  report equal to the JAX one, and its stale state n times smaller than
  the gather layout's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.models import unet as jax_unet
from distrifuser_tpu.ops.attention import attention as jax_attention
from distrifuser_tpu.ops.ring_attention import ring_pass as jax_ring_pass
from distrifuser_tpu.ops.ring_attention import ring_self_attention as jax_ring_attention
from distrifuser_tpu.parallel.context import PHASE_STALE, PHASE_SYNC, PatchContext
from distrifuser_tpu.parallel.runner import make_runner as make_jax_runner
from distrifuser_tpu.schedulers import get_scheduler
from distrifuser_tpu.utils.compat import shard_map
from distrifuser_tpu.utils.config import SP_AXIS
from distrifuser_tpu_torch.models.weights import params_from_jax
from distrifuser_tpu_torch.ops.flash_attention import flash_sdpa_reference
from distrifuser_tpu_torch.ops.ring_attention import merge_partials
from test_torch_port_ranks import ring_worker, run_ranks

TOL = 2e-4
RTOL, ATOL = 1e-4, 1e-5
HEADS, CHUNK, B = 2, 4, 2
C = HEADS * 8


@pytest.mark.parametrize("kv_len", [None, 37])
def test_reference_lse_matches_float64(kv_len):
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(2, n, 3 * 16).astype(np.float32) for n in (24, 40, 40))
    out, lse = flash_sdpa_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), heads=3, kv_len=kv_len,
                                    return_lse=True)
    assert out.dtype == lse.dtype == torch.float32
    assert tuple(lse.shape) == (2, 3, 24)
    lk = 40 if kv_len is None else kv_len
    qh = q.reshape(2, 24, 3, 16).transpose(0, 2, 1, 3).astype(np.float64)
    kh = k[:, :lk].reshape(2, lk, 3, 16).transpose(0, 2, 1, 3).astype(np.float64)
    vh = v[:, :lk].reshape(2, lk, 3, 16).transpose(0, 2, 1, 3).astype(np.float64)
    s = qh @ kh.transpose(0, 1, 3, 2) / 4.0
    want_lse = np.logaddexp.reduce(s, axis=-1)
    want = (np.exp(s - want_lse[..., None]) @ vh).transpose(0, 2, 1, 3).reshape(2, 24, 48)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    # the plain call is the same output in q's dtype
    plain = flash_sdpa_reference(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), heads=3, kv_len=kv_len)
    assert torch.equal(plain, out)


def test_merge_partials_equals_whole():
    rs = np.random.RandomState(1)
    q = torch.from_numpy(rs.randn(2, 12, C).astype(np.float32))
    k, v = (torch.from_numpy(rs.randn(2, 20, C).astype(np.float32)) for _ in range(2))
    whole = flash_sdpa_reference(q, k, v, heads=HEADS, return_lse=True)
    halves = [flash_sdpa_reference(q, k[:, s], v[:, s], heads=HEADS, return_lse=True)
              for s in (slice(0, 7), slice(7, 20))]
    out, lse = merge_partials(halves[0], halves[1], HEADS)
    np.testing.assert_allclose(out.numpy(), whole[0].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), whole[1].numpy(), rtol=1e-6, atol=1e-6)


def _attn_params():
    rs = np.random.RandomState(2)
    f = lambda *s: (0.3 * rs.randn(*s)).astype(np.float32)  # noqa: E731
    return {"to_q": {"kernel": f(C, C)}, "to_kv": {"kernel": f(C, 2 * C)},
            "to_out": {"kernel": f(C, C), "bias": f(C)}}


def _ops_inputs(n):
    rs = np.random.RandomState(10 + n)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    return {"tokens1": f(B, CHUNK * n, C), "tokens2": f(B, CHUNK * n, C),
            "q": f(n, B, 6, C), "kv": f(n, B, CHUNK, 2 * C), "kv_static": f(B, 5, 2 * C)}


def _sp(devices, n, fn, in_specs, out_specs):
    mesh = Mesh(np.array(devices[:n]), axis_names=(SP_AXIS,))
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                             check_vma=False))


def _jax_ops(devices, n, inp, p):
    row = P(None, SP_AXIS)
    ref = {}
    for mode in ("full_sync", "corrected_async_gn"):
        def sync(xl, mode=mode):
            ctx = PatchContext(n=n, mode=mode, phase=PHASE_SYNC, attn_impl="ring")
            y = jax_ring_attention(p, xl, ctx, "attn", heads=HEADS)
            return y, ctx.state_out["attn"][None]

        def stale(xl, st, mode=mode):
            ctx = PatchContext(n=n, mode=mode, phase=PHASE_STALE, attn_impl="ring",
                               state_in={"attn": st[0]})
            return jax_ring_attention(p, xl, ctx, "attn", heads=HEADS)

        y1, st = _sp(devices, n, sync, row, (row, P(SP_AXIS)))(inp["tokens1"])
        y2 = _sp(devices, n, stale, (row, P(SP_AXIS)), row)(inp["tokens2"], st)
        ref[mode] = (np.asarray(y1), np.asarray(st), np.asarray(y2))

    def rp(q, kv, static=None):
        out = jax_ring_pass(q[0], kv[0], kv[0], n, SP_AXIS, heads=HEADS, kv_static=static)
        b, h, lq, d = out.shape
        return out.transpose(0, 2, 1, 3).reshape(b, lq, h * d)[None]

    ref["ring_pass"] = np.asarray(_sp(devices, n, rp, (P(SP_AXIS),) * 2, P(SP_AXIS))(
        inp["q"], inp["kv"]))
    ref["ring_pass_static"] = np.asarray(_sp(
        devices, n, lambda q, kv, s: rp(q, kv, s), (P(SP_AXIS),) * 2 + (P(),),
        P(SP_AXIS))(inp["q"], inp["kv"], inp["kv_static"]))
    ref["dense"] = np.asarray(jax_attention(p, jnp.asarray(inp["tokens1"]), heads=HEADS))
    return ref


def _runner_inputs():
    ucfg = jax_unet.tiny_config(cross_attention_dim=32, sdxl=True)
    params = jax_unet.init_unet_params(jax.random.PRNGKey(0), ucfg)
    rs = np.random.RandomState(3)
    latents = rs.randn(1, 16, 16, 4).astype(np.float32)
    enc = rs.randn(2, 1, 7, 32).astype(np.float32)
    added = {"text_embeds": rs.randn(2, 1, 32).astype(np.float32),
             "time_ids": np.tile(np.float32([128, 128, 0, 0, 128, 128]), (2, 1, 1))}
    return ucfg, params, latents, enc, added


RING_RUNNER = {2: {"split_batch": False}, 4: {}}  # sp 2, and CFG 2 x sp 2
STEPS = 4


@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def world(request, devices8, tmp_path_factory):
    n = request.param
    inp, p = _ops_inputs(n), _attn_params()
    ucfg, params, latents, enc, added = _runner_inputs()
    base = {"warmup_steps": 1, "use_cuda_graph": False, **RING_RUNNER[n]}
    tmp = tmp_path_factory.mktemp(f"ring{n}")
    port_inp = {k: torch.from_numpy(v) for k, v in inp.items()}
    port_inp.update(attn=params_from_jax(p), heads=HEADS, runner={
        "cases": [{"attn_impl": "ring"}, {"attn_impl": "gather"}], "base": base,
        "steps": STEPS, "params": params_from_jax(jax.device_get(params)),
        "latents": torch.from_numpy(latents), "enc": torch.from_numpy(enc),
        "added": {k: torch.from_numpy(v) for k, v in added.items()}})
    torch.save(port_inp, tmp / "ring.pt")
    run_ranks(n, ring_worker, tmp, str(tmp / "ring.pt"), str(tmp / "ring_out"))
    port = [torch.load(f"{tmp / 'ring_out'}.rank{r}") for r in range(n)]
    jcfg = JaxDistriConfig(devices=devices8[:n], height=128, width=128, attn_impl="ring",
                           **{k: v for k, v in base.items() if k != "use_cuda_graph"})
    jrunner = make_jax_runner(jcfg, ucfg, params, get_scheduler("ddim"))
    want_x = np.asarray(jrunner.generate(latents, enc, added_cond=added,
                                         num_inference_steps=STEPS, guidance_scale=5.0))
    want_rep = jrunner.comm_volume_report(per_phase=True)
    return n, port, _jax_ops(devices8, n, inp, p), (want_x, want_rep)


def _rows(a, r, n):
    return np.split(np.asarray(a), n, axis=1)[r]


def test_ring_pass_matches_jax(world):
    n, port, ref, _ = world
    for r in range(n):
        for key in ("ring_pass", "ring_pass_static"):
            np.testing.assert_allclose(port[r][key].numpy(), ref[key][r], rtol=RTOL,
                                       atol=ATOL, err_msg=f"rank {r} {key}")


def test_ring_sync_equals_dense_and_jax(world):
    n, port, ref, _ = world
    for r in range(n):
        for mode in ("full_sync", "corrected_async_gn"):
            got = port[r][("ring", mode)]
            y1, st, _ = ref[mode]
            np.testing.assert_allclose(got["y_sync"].numpy(), _rows(ref["dense"], r, n),
                                       atol=TOL)
            np.testing.assert_allclose(got["y_sync"].numpy(), _rows(y1, r, n), rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(got["state_sync"]["attn"].numpy(), st[r],
                                       rtol=RTOL, atol=ATOL)


def test_ring_stale_equals_gather_stale_and_jax(world):
    n, port, ref, _ = world
    for r in range(n):
        ring = port[r][("ring", "corrected_async_gn")]
        gather = port[r][("gather", "corrected_async_gn")]
        np.testing.assert_allclose(ring["y_stale"].numpy(), gather["y_stale"].numpy(),
                                   atol=TOL)
        np.testing.assert_allclose(ring["y_stale"].numpy(),
                                   _rows(ref["corrected_async_gn"][2], r, n),
                                   rtol=RTOL, atol=ATOL)
        # the ring's buffer is this rank's chunk, the gathered one all n
        assert gather["state_stale"]["attn"].numel() == n * ring["state_stale"]["attn"].numel()
        # full_sync: the stale step is a synchronous one, exact
        fs = port[r][("ring", "full_sync")]
        np.testing.assert_allclose(fs["y_stale"].numpy(),
                                   _rows(ref["full_sync"][2], r, n), rtol=RTOL, atol=ATOL)


def test_ring_runner_matches_jax(world):
    n, port, _, (want_x, want_rep) = world
    runs = port[0]["runner"]
    x, rep, phases, _ = runs[(("attn_impl", "ring"),)]
    for r in range(1, n):
        assert torch.equal(port[r]["runner"][(("attn_impl", "ring"),)][0], x)
    err = np.abs(x.numpy() - want_x).max() / np.abs(want_x).max()
    assert err <= TOL, err
    assert rep["phases"] == want_rep["phases"]
    assert rep["bytes"] == want_rep["bytes"]
    assert rep["flops"] is None and want_rep["flops"] is None  # no step cache
    assert phases == {"sync": 2, "stale": STEPS - 2}
    # the ring holds n times less KV than the gather layout, the rest alike
    gather = runs[(("attn_impl", "gather"),)][1]
    sp = n if n == 2 else 2
    for phase in ("sync", "stale"):
        assert gather["phases"][phase]["attn"] == sp * rep["phases"][phase]["attn"]
        assert gather["phases"][phase]["conv2d"] == rep["phases"][phase]["conv2d"]
    gx = runs[(("attn_impl", "gather"),)][0]
    assert np.abs(x.numpy() - gx.numpy()).max() / np.abs(gx.numpy()).max() <= TOL
