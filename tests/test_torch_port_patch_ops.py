"""PyTorch port: each patch op on n gloo ranks against the JAX package at the
same n on its fake CPU mesh.

The same seeded numpy inputs go through the JAX op under ``shard_map``
over an ``sp`` mesh of n CPU devices and through the port's op on n gloo
ranks (tests/test_torch_port_ranks.py ``ops_worker``), in float32:
``halo_exchange``, ``gather_rows``, ``sliced_conv2d``, ``patch_conv2d``
(a synchronous call, then a stale one on new input with the buffers of the
first), ``patch_group_norm`` in all six modes (sync, then stale),
``patch_self_attention`` (sync, then stale) and the ``cfg_split`` combine
(at world n: CFG 2 x sp n/2).  Each rank's output and buffers are held to
rtol 1e-4 and atol 1e-5, at n = 2 and 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.ops.attention import patch_self_attention
from distrifuser_tpu.ops.conv import patch_conv2d, sliced_conv2d
from distrifuser_tpu.ops.normalization import patch_group_norm
from distrifuser_tpu.parallel import collectives
from distrifuser_tpu.parallel.context import PHASE_STALE, PHASE_SYNC, PatchContext
from distrifuser_tpu.parallel.guidance import combine_guidance
from distrifuser_tpu.utils.compat import shard_map
from distrifuser_tpu.utils.config import CFG_AXIS, DP_AXIS, SP_AXIS, SYNC_MODES
from distrifuser_tpu_torch.models.weights import params_from_jax
from test_torch_port_ranks import ops_worker, run_ranks

RTOL, ATOL = 1e-4, 1e-5
WORLDS = (2, 4)
B, H, W, C = 2, 16, 6, 8  # rows divide by 2 * 4 (stride 2 at n = 4)


def _inputs():
    rs = np.random.RandomState(0)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    return {
        "x1": f(B, H, W, C), "x2": f(B, H, W, C),
        "tokens1": f(B, 32, C), "tokens2": f(B, 32, C),
        "conv": {"kernel": 0.2 * f(3, 3, C, 5), "bias": 0.1 * f(5)},
        "gn": {"scale": 1 + 0.1 * f(C), "bias": 0.1 * f(C)},
        "attn": {"to_q": {"kernel": 0.3 * f(C, C)},
                 "to_kv": {"kernel": 0.3 * f(C, 2 * C)},
                 "to_out": {"kernel": 0.3 * f(C, C), "bias": 0.1 * f(C)}},
        "branches": f(2, B, H, W, 4),
    }


def _to_port(inp):
    return {k: params_from_jax(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in inp.items()}


def _sp(devices, n, fn, in_specs, out_specs):
    mesh = Mesh(np.array(devices[:n]), axis_names=(SP_AXIS,))
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                             check_vma=False))


def _jax_two_steps(devices, n, op, x1, x2, mode="corrected_async_gn"):
    """(y_sync, state_sync, y_stale, state_stale), states stacked per device."""
    row = P(None, SP_AXIS)

    def sync(xl):
        ctx = PatchContext(n=n, mode=mode, phase=PHASE_SYNC)
        y = op(xl, ctx)
        return y, {k: v[None] for k, v in ctx.state_out.items()}

    def stale(xl, st):
        ctx = PatchContext(n=n, mode=mode, phase=PHASE_STALE,
                           state_in={k: v[0] for k, v in st.items()})
        y = op(xl, ctx)
        return y, {k: v[None] for k, v in ctx.state_out.items()}

    y1, s1 = _sp(devices, n, sync, row, (row, P(SP_AXIS)))(x1)
    y2, s2 = _sp(devices, n, stale, (row, P(SP_AXIS)), (row, P(SP_AXIS)))(x2, s1)
    # a step that refreshes nothing (no_sync) keeps its buffers
    return {"y_sync": y1, "state_sync": s1, "y_stale": y2, "state_stale": s2 or s1}


def _jax_reference(devices, n, inp):
    x1, x2 = jnp.asarray(inp["x1"]), jnp.asarray(inp["x2"])
    row = P(None, SP_AXIS)
    ref = {}
    for halo in (1, 2):
        ref[f"halo_exchange_h{halo}"] = _sp(
            devices, n, lambda xl, h=halo: tuple(
                v[None] for v in collectives.halo_exchange(xl, h, n)),
            row, P(SP_AXIS))(x1)
    ref["gather_rows"] = _sp(devices, n, lambda xl: collectives.gather_rows(xl)[None],
                             row, P(SP_AXIS))(x1)
    for s in (1, 2):
        ref[f"sliced_conv2d_s{s}"] = _sp(
            devices, n, lambda x, s=s: sliced_conv2d(
                inp["conv"], x, PatchContext(n=n, mode="full_sync", phase=PHASE_SYNC),
                stride=s),
            P(), row)(x1)
        ref[f"patch_conv2d_s{s}"] = _jax_two_steps(
            devices, n, lambda x, c, s=s: patch_conv2d(inp["conv"], x, c, "conv", stride=s),
            x1, x2)
    for mode in SYNC_MODES:
        ref[f"patch_group_norm_{mode}"] = _jax_two_steps(
            devices, n, lambda x, c: patch_group_norm(inp["gn"], x, c, "gn", groups=4),
            x1, x2, mode)
    ref["patch_self_attention"] = _jax_two_steps(
        devices, n, lambda x, c: patch_self_attention(inp["attn"], x, c, "attn", heads=2),
        jnp.asarray(inp["tokens1"]), jnp.asarray(inp["tokens2"]))
    cfg = JaxDistriConfig(devices=devices[:n], height=8 * n, width=8)
    ref["cfg_combine"] = jax.jit(shard_map(
        lambda o: combine_guidance(cfg, o[0], jnp.float32(5.0), B), mesh=cfg.mesh,
        in_specs=P(CFG_AXIS), out_specs=P(), check_vma=False))(
            jnp.asarray(inp["branches"]))
    assert cfg.mesh.shape[DP_AXIS] == 1 and cfg.mesh.shape[CFG_AXIS] == 2
    return ref


@pytest.fixture(scope="module")
def results(devices8, tmp_path_factory):
    inp = _inputs()
    tmp = tmp_path_factory.mktemp("patch_ops")
    torch.save(_to_port(inp), tmp / "inputs.pt")
    out = {}
    for n in WORLDS:
        run_ranks(n, ops_worker, tmp, str(tmp / "inputs.pt"), str(tmp / f"out{n}"))
        port = [torch.load(f"{tmp / f'out{n}'}.rank{r}") for r in range(n)]
        out[n] = (port, _jax_reference(devices8, n, inp))
    return out


def _rank_rows(a, rank, n, dim=1):
    return np.split(np.asarray(a), n, axis=dim)[rank]


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _check_two_steps(port, ref, n):
    for r in range(n):
        for key in ("y_sync", "y_stale"):
            _close(port[r][key], _rank_rows(ref[key], r, n), f"rank {r} {key}")
        for key in ("state_sync", "state_stale"):
            assert set(port[r][key]) == set(ref[key]), (key, set(port[r][key]))
            for name, buf in port[r][key].items():
                _close(buf, np.asarray(ref[key][name])[r], f"rank {r} {key} {name}")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("halo", [1, 2])
def test_halo_exchange(results, n, halo):
    port, ref = results[n]
    for r in range(n):
        for got, want in zip(port[r][f"halo_exchange_h{halo}"],
                             ref[f"halo_exchange_h{halo}"]):
            _close(got, np.asarray(want)[r], f"rank {r}")
    # the image border receives zeros
    assert not port[0][f"halo_exchange_h{halo}"][0].any()
    assert not port[n - 1][f"halo_exchange_h{halo}"][1].any()


@pytest.mark.parametrize("n", WORLDS)
def test_gather_rows(results, n):
    port, ref = results[n]
    for r in range(n):
        _close(port[r]["gather_rows"], np.asarray(ref["gather_rows"])[r], f"rank {r}")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("stride", [1, 2])
def test_sliced_conv2d(results, n, stride):
    port, ref = results[n]
    for r in range(n):
        _close(port[r][f"sliced_conv2d_s{stride}"],
               _rank_rows(ref[f"sliced_conv2d_s{stride}"], r, n), f"rank {r}")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("stride", [1, 2])
def test_patch_conv2d_sync_then_stale(results, n, stride):
    port, ref = results[n]
    _check_two_steps([p[f"patch_conv2d_s{stride}"] for p in port],
                     ref[f"patch_conv2d_s{stride}"], n)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("mode", SYNC_MODES)
def test_patch_group_norm_sync_then_stale(results, n, mode):
    port, ref = results[n]
    _check_two_steps([p[f"patch_group_norm_{mode}"] for p in port],
                     ref[f"patch_group_norm_{mode}"], n)


@pytest.mark.parametrize("n", WORLDS)
def test_patch_self_attention_sync_then_stale(results, n):
    port, ref = results[n]
    _check_two_steps([p["patch_self_attention"] for p in port],
                     ref["patch_self_attention"], n)


@pytest.mark.parametrize("n", WORLDS)
def test_cfg_split_combine(results, n):
    port, ref = results[n]
    for r in range(n):
        _close(port[r]["cfg_combine"], ref["cfg_combine"], f"rank {r}")
