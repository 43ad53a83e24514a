"""PyTorch port: the comm knobs of the displaced patch path against the JAX
package at the same rank count.

* ``take_every_kth`` / ``scatter_every_kth`` / ``wire_nbytes`` and the
  mode and fraction validation equal the JAX package's, bit for bit;
* one stale step's refresh emissions (a KV gather, a halo pair, GroupNorm
  moments) on identical inputs at 2 gloo ranks, for every
  ``comm_compress`` mode, at ``refresh_fraction`` 1 and 0.5, and batched
  (``batch_comm``): the next step's buffers equal the JAX package's, the
  exact refreshes bit for bit and the lossy ones within 1e-6 of their
  largest value: the same float32 rows quantize to the same int8 / e4m3
  payloads (one payload step apart would be 1e-2), and only the float32
  scale may differ in its last bit, as XLA turns the division by 127 or
  448 into a multiplication; the wire bytes are equal; batched equals
  unbatched bit for bit;
* the tiny SDXL runner at 2 gloo ranks (sp 2, CFG folded into the batch,
  warmup 1, 5 DDIM steps) for none, int8, fp8, int8_residual, fraction
  0.5, int8 with fraction 0.5 and the step cache with int8:
  ``comm_volume_report(per_phase=True)``'s ``phases`` and ``bytes`` and the
  ``comm_plan`` totals equal the JAX package's, and the latents agree with
  the JAX run of the same knob (``LATENT_TOL``, ``LATENT_RUNS``);
  ``comm_batch`` equals the
  unbatched run bit for bit.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.models import unet as jax_unet
from distrifuser_tpu.parallel import compress as jax_compress
from distrifuser_tpu.parallel.context import (PHASE_STALE, WIRE_REGISTRY,
                                              PatchContext)
from distrifuser_tpu.parallel.runner import make_runner as make_jax_runner
from distrifuser_tpu.pipelines import DistriSDXLPipeline as JaxSDXLPipeline
from distrifuser_tpu.schedulers import get_scheduler
from distrifuser_tpu.utils.compat import shard_map
from distrifuser_tpu.utils.config import SP_AXIS
from distrifuser_tpu_torch.models.weights import params_from_jax
from distrifuser_tpu_torch.parallel import compress as port_compress
from test_torch_port_ranks import knobs_worker, refresh_worker, run_ranks

WORLD = 2
STEPS = 5
# latent agreement with the JAX run of the same knob, relative to the
# largest magnitude: the whole-UNet tolerance where every refresh is exact;
# a quantized refresh may round an element differently where the two
# frameworks' activations differ by ~1e-6 (measured: int8 2.0e-5, fp8
# 4.0e-5, int8_residual 2.4e-6, int8 with fraction 0.5 2.2e-5), so those
# carry a bound of 5e-4
LATENT_TOL = {"none": 2e-4, "int8": 5e-4, "fp8": 5e-4, "int8_residual": 5e-4}

KNOBS = [
    {},
    {"comm_compress": "int8"},
    {"comm_compress": "fp8"},
    {"comm_compress": "int8_residual"},
    {"refresh_fraction": 0.5},
    {"comm_compress": "int8", "refresh_fraction": 0.5},
    {"comm_compress": "int8", "step_cache_interval": 2, "step_cache_depth": 1},
]
# the knobs whose latents are held to a JAX run (each JAX run compiles its
# loop, seconds apiece): every compression mode, the partial refresh (with
# int8) and the step cache; none is held by
# tests/test_torch_port_patch_runner.py
LATENT_RUNS = (
    (("comm_compress", "fp8"),), (("comm_compress", "int8_residual"),),
    (("comm_compress", "int8"), ("refresh_fraction", 0.5)),
    (("comm_compress", "int8"), ("step_cache_depth", 1), ("step_cache_interval", 2)))
BATCHED = [{"comm_batch": True}, {"comm_batch": True, "comm_compress": "int8_residual"}]


def _key(case):
    return tuple(sorted(case.items()))


# -- the helpers ------------------------------------------------------------


@pytest.mark.parametrize("k, groups", [(1, 1), (2, 1), (4, 1), (2, 2), (4, 2)])
def test_take_scatter_every_kth_match_jax(k, groups):
    rs = np.random.RandomState(k * 10 + groups)
    x = rs.randn(2, 3, 16, 5).astype(np.float32)
    for r in range(k):
        want = np.asarray(jax_compress.take_every_kth(jnp.asarray(x), k, r, groups=groups))
        got = port_compress.take_every_kth(torch.from_numpy(x), k, r, groups=groups)
        np.testing.assert_array_equal(got.numpy(), want)
        # the rotation as a device tensor selects the same rows
        got_t = port_compress.take_every_kth(torch.from_numpy(x), k, torch.tensor(r),
                                             groups=groups)
        np.testing.assert_array_equal(got_t.numpy(), want)
        rows = rs.randn(*want.shape).astype(np.float32)
        want_s = np.asarray(jax_compress.scatter_every_kth(
            jnp.asarray(x), jnp.asarray(rows), k, r, groups=groups))
        got_s = port_compress.scatter_every_kth(torch.from_numpy(x), torch.from_numpy(rows),
                                                k, torch.tensor(r), groups=groups)
        np.testing.assert_array_equal(got_s.numpy(), want_s)
    with pytest.raises(ValueError, match="divisible"):
        port_compress.take_every_kth(torch.zeros(2, 6, 3), 4, 0)


def test_wire_bytes_and_validation_match_jax():
    for shape in [(2, 8, 16), (1, 1, 64, 32), (3,), ()]:
        for itemsize in (2, 4):
            for mode in jax_compress.COMPRESS_MODES:
                assert (port_compress.wire_nbytes(shape, itemsize, mode)
                        == jax_compress.wire_nbytes(shape, itemsize, mode))
    assert port_compress.COMPRESS_MODES == jax_compress.COMPRESS_MODES
    assert port_compress.COMPRESS_KINDS == jax_compress.COMPRESS_KINDS
    for f in (1.0, 0.5, 0.25, 1 / 3, 0.3, 0.0, 1.5, -0.5):
        raised = []
        for mod in (jax_compress, port_compress):
            try:
                mod.validate_refresh_fraction(f)
                raised.append(None)
            except ValueError:
                raised.append("ValueError")
        assert raised[0] == raised[1], f
        if raised[0] is None:
            assert port_compress.refresh_period(f) == jax_compress.refresh_period(f)
    for mode in ("none", "int8", "fp8", "int8_residual", "int4"):
        raised = []
        for mod in (jax_compress, port_compress):
            try:
                mod.validate_mode(mode)
                raised.append(None)
            except ValueError:
                raised.append("ValueError")
        assert raised[0] == raised[1], mode


# -- one stale step's refreshes on identical inputs ------------------------

B, L, C, H_ROWS, W, G = 2, 16, 8, 4, 6, 4
REFRESH_CASES = [
    (("compress", c), ("refresh_fraction", f))
    for c in ("none", "int8", "fp8", "int8_residual") for f in (1.0, 0.5)
] + [(("batch_comm", True), ("compress", c))
     for c in ("none", "int8", "fp8", "int8_residual")]


def _refresh_inputs():
    rs = np.random.RandomState(5)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    n, chunk = WORLD, L // WORLD
    gathered = f(n, B, chunk, C)  # the same gathered KV on every rank
    halos = f(n, 2, B, 1, W, C)
    halos[0, 0] = 0  # the image border holds zeros
    halos[n - 1, 1] = 0
    return {
        "kv": f(n, B, chunk, C), "x": f(n, B, H_ROWS, W, C), "moments": f(n, 2, B, G),
        "state": {"attn": np.stack([gathered] * n), "conv": halos,
                  "conv#own": f(n, 2, B, 1, W, C), "gn": np.stack([f(n, 2, B, G)] * n)},
        "step": 1,
    }


def _jax_refresh(devices, inp, case):
    n = WORLD
    mesh = Mesh(np.array(devices[:n]), axis_names=(SP_AXIS,))
    fields = dict(case)
    state = dict(inp["state"])
    if fields.get("compress") != "int8_residual":
        state.pop("conv#own")

    def step(kv, x, m, st):
        ctx = PatchContext(n=n, mode="corrected_async_gn", phase=PHASE_STALE,
                           state_in={k: v[0] for k, v in st.items()}, step=inp["step"],
                           **fields)
        ctx.emit_refresh_gather("attn", kv[0], kind="attn")
        ctx.emit_refresh_halos("conv", x[0], 1)
        ctx.emit_refresh_gather("gn", m[0], kind="gn")
        ctx.flush()
        return {k: v[None] for k, v in ctx.state_out.items()}

    WIRE_REGISTRY.clear()
    got = jax.jit(shard_map(step, mesh=mesh, in_specs=(P(SP_AXIS),) * 4,
                            out_specs=P(SP_AXIS), check_vma=False))(
        inp["kv"], inp["x"], inp["moments"], state)
    return {k: np.asarray(v) for k, v in got.items()}, dict(WIRE_REGISTRY)


@pytest.fixture(scope="module")
def refreshes(devices8, tmp_path_factory):
    inp = _refresh_inputs()
    tmp = tmp_path_factory.mktemp("refresh")
    port_inp = {k: torch.from_numpy(v) for k, v in inp.items() if isinstance(v, np.ndarray)}
    port_inp["state"] = {k: torch.from_numpy(v) for k, v in inp["state"].items()}
    port_inp["step"] = inp["step"]
    port_inp["cases"] = REFRESH_CASES
    torch.save(port_inp, tmp / "refresh.pt")
    run_ranks(WORLD, refresh_worker, tmp, str(tmp / "refresh.pt"), str(tmp / "refresh_out"))
    port = [torch.load(f"{tmp / 'refresh_out'}.rank{r}") for r in range(WORLD)]
    jax_out = {case: _jax_refresh(devices8, inp, case) for case in REFRESH_CASES}
    return port, jax_out


@pytest.mark.parametrize("case", REFRESH_CASES, ids=lambda c: "-".join(str(v) for _, v in c))
def test_refresh_buffers_and_wire_equal_jax(refreshes, case):
    port, jax_out = refreshes
    want, want_wire = jax_out[case]
    for r in range(WORLD):
        state, wire, kinds = port[r][case]
        assert set(state) == set(want), (set(state), set(want))
        lossy = dict(case).get("compress", "none") != "none"
        for name, buf in state.items():
            if lossy:
                scale = np.abs(want[name][r]).max()
                np.testing.assert_allclose(buf.numpy(), want[name][r], rtol=0,
                                           atol=1e-6 * scale, err_msg=f"{r} {name}")
            else:
                np.testing.assert_array_equal(buf.numpy(), want[name][r],
                                              err_msg=f"{r} {name}")
        for name, buf in state.items():
            default = 0 if kinds[name] == "local" else buf.numel() * buf.element_size()
            assert wire.get(name, default) == want_wire.get(name, default), name
    if dict(case).get("compress", "none") != "none":
        # a lossy refresh differs from the exact one
        exact = jax_out[(("compress", "none"), ("refresh_fraction", 1.0))][0]
        assert not np.array_equal(want["attn"], exact["attn"])


def test_batched_refresh_equals_unbatched(refreshes):
    port, _ = refreshes
    for mode in ("none", "int8", "fp8", "int8_residual"):
        for r in range(WORLD):
            batched = port[r][(("batch_comm", True), ("compress", mode))][0]
            single = port[r][(("compress", mode), ("refresh_fraction", 1.0))][0]
            assert set(batched) == set(single)
            for name in single:
                assert torch.equal(batched[name], single[name]), (mode, name)


# -- the runner -------------------------------------------------------------


def _runner_inputs():
    ucfg = jax_unet.tiny_config(cross_attention_dim=32, sdxl=True)
    params = jax_unet.init_unet_params(jax.random.PRNGKey(0), ucfg)
    rs = np.random.RandomState(3)
    latents = rs.randn(1, 16, 16, 4).astype(np.float32)
    enc = rs.randn(2, 1, 7, 32).astype(np.float32)
    added = {"text_embeds": rs.randn(2, 1, 32).astype(np.float32),
             "time_ids": np.tile(np.float32([128, 128, 0, 0, 128, 128]), (2, 1, 1))}
    return ucfg, params, latents, enc, added


BASE = {"split_batch": False, "warmup_steps": 1, "use_cuda_graph": False}


@pytest.fixture(scope="module")
def runs(devices8, tmp_path_factory):
    ucfg, params, latents, enc, added = _runner_inputs()
    tmp = tmp_path_factory.mktemp("knobs")
    torch.save({"cases": KNOBS + BATCHED, "base": BASE, "steps": STEPS,
                "params": params_from_jax(jax.device_get(params)),
                "latents": torch.from_numpy(latents), "enc": torch.from_numpy(enc),
                "added": {k: torch.from_numpy(v) for k, v in added.items()}},
               tmp / "knobs.pt")
    run_ranks(WORLD, knobs_worker, tmp, str(tmp / "knobs.pt"), str(tmp / "knobs_out"))
    port = [torch.load(f"{tmp / 'knobs_out'}.rank{r}") for r in range(WORLD)]
    jax_runs = {}
    for case in KNOBS:
        # the JAX package runs its fused loop (use_cuda_graph is its
        # compiled step)
        jcfg = JaxDistriConfig(devices=devices8[:WORLD], height=128, width=128,
                               **{**BASE, **case, "use_cuda_graph": True})
        jrunner = make_jax_runner(jcfg, ucfg, params, get_scheduler("ddim"))
        x = None
        if _key(case) in LATENT_RUNS:
            x = np.asarray(jrunner.generate(latents, enc, added_cond=added,
                                            num_inference_steps=STEPS, guidance_scale=5.0))
        rep = jrunner.comm_volume_report(per_phase=True)
        # the JAX plan prices the report already taken (a second one would
        # trace every phase again)
        priced = SimpleNamespace(comm_volume_report=lambda per_phase, rep=rep: rep)
        plan = JaxSDXLPipeline.comm_plan(
            SimpleNamespace(distri_config=jcfg, runner=priced), STEPS)
        jax_runs[_key(case)] = (x, rep, plan)
    return port, jax_runs


@pytest.mark.parametrize("case", KNOBS, ids=lambda c: "-".join(f"{v}" for v in c.values())
                         or "none")
def test_runner_knob_matches_jax(runs, case):
    port, jax_runs = runs
    want_x, want_rep, want_plan = jax_runs[_key(case)]
    x, rep, phases, plan = port[0][_key(case)]
    for r in range(1, WORLD):  # every rank holds the same latent
        assert torch.equal(port[r][_key(case)][0], x)
    assert rep["phases"] == want_rep["phases"]
    assert rep["bytes"] == want_rep["bytes"]
    assert rep["refresh_fraction"] == want_rep["refresh_fraction"]
    # the FLOP counts: the port's convs, GEMMs and attention products, XLA's
    # everything (tests/test_torch_port_flops.py RATIO_TOL)
    if want_rep["flops"] is None:
        assert rep["flops"] is None
    else:
        assert abs(rep["flops"]["shallow_ratio"] - want_rep["flops"]["shallow_ratio"]) <= 0.02
    assert plan == {k: want_plan[k] for k in plan}
    assert plan["total_bytes"] == want_plan["total_bytes"]
    if want_x is not None:
        tol = LATENT_TOL[case.get("comm_compress", "none")]
        err = np.abs(x.numpy() - want_x).max() / np.abs(want_x).max()
        assert err <= tol, err
    sc = "step_cache_interval" in case
    assert phases == ({"sync": 2, "stale": 1, "shallow": 2} if sc
                      else {"sync": 2, "stale": 3})


def test_int8_and_partial_refresh_shrink_the_stale_bytes(runs):
    """The byte gates of the JAX package on the port's own reports: int8
    cuts the stale refresh bytes (GroupNorm moments stay exact, sync bytes
    unchanged), fraction 0.5 halves the halo and KV refreshes."""
    port, _ = runs
    rep = {k: port[0][k][1] for k in port[0]}
    off, int8 = rep[_key({})], rep[_key({"comm_compress": "int8"})]
    half = rep[_key({"refresh_fraction": 0.5})]
    assert off["bytes"]["sync"] == int8["bytes"]["sync"] == half["bytes"]["sync"]
    assert off["phases"] == int8["phases"]
    for kind in ("attn", "conv2d"):
        assert int8["bytes"]["stale"][kind] < off["bytes"]["stale"][kind]
        assert half["bytes"]["stale"][kind] * 2 == off["bytes"]["stale"][kind]
    assert int8["bytes"]["stale"]["gn"] == off["bytes"]["stale"]["gn"]
    assert sum(off["bytes"]["stale"].values()) / sum(int8["bytes"]["stale"].values()) > 3


@pytest.mark.parametrize("case", BATCHED, ids=["none", "int8_residual"])
def test_comm_batch_equals_unbatched(runs, case):
    port, _ = runs
    single = {k: v for k, v in case.items() if k != "comm_batch"}
    for r in range(WORLD):
        x, rep, _, _ = port[r][_key(case)]
        x1, rep1, _, _ = port[r][_key(single)]
        assert torch.equal(x, x1)
        assert rep["bytes"] == rep1["bytes"]


def test_knob_config_fields_match_jax():
    """The port's DistriConfig carries the JAX package's knob fields with
    its defaults."""
    jf = {f.name: f.default for f in dataclasses.fields(JaxDistriConfig)}
    from distrifuser_tpu_torch.utils.config import DistriConfig

    pf = {f.name: f.default for f in dataclasses.fields(DistriConfig)}
    for name in ("comm_batch", "comm_compress", "refresh_fraction",
                 "step_cache_interval", "step_cache_depth", "attn_impl"):
        assert pf[name] == jf[name], name


def test_partial_refresh_names_the_layer_whose_rows_do_not_divide():
    """A refreshed row count the period does not divide is refused before
    anything is exchanged, naming the layer (here a halo of 5 columns at
    k = 2)."""
    from distrifuser_tpu_torch.parallel.context import PatchContext as PortContext

    ctx = PortContext(n=2, mode="corrected_async_gn", phase="stale", refresh_fraction=0.5,
                      step=1, state_in={"conv": torch.zeros(2, 1, 1, 5, 4)})
    with pytest.raises(ValueError, match="layer 'conv'.*divisible"):
        ctx.emit_refresh_halos("conv", torch.zeros(1, 4, 5, 4), 1)
