"""PyTorch port: the comm knobs of both transformer runners (the step cache,
refresh compression and the partial refresh, PCPP) against the JAX
``DiTDenoiseRunner`` and ``MMDiTDenoiseRunner`` at the same n.

At world 4 (CFG 2 x sp 2, warmup 1, 6 steps: 2 synchronous, then stale or,
under the step cache at interval 2, 2 shallow and 2 full) on gloo ranks
(the workers of tests/test_torch_port_ranks.py) and on the JAX package's
fake CPU mesh of 4 devices, from the same seeded weights and inputs:

* the tiny DiT (``tiny_dit_config(depth=2)``, 4 heads): "gather" with int8
  and ``refresh_fraction=0.5``, ``int8_residual``, ``fp8``, and the step
  cache at interval 2, depth 1, alone and with int8;
* the tiny MMDiT (depth 2) and one with a dual-attention block (depth 3,
  one dual block, q/k norms): the step cache at depth 1 (the cut past the
  dual prefix) with int8 and ``refresh_fraction=0.5``;

each latent within 5e-4 of the JAX one's largest value, the same on every
rank, its ``comm_report`` at batch 1 and 2 and the pipelines'
``comm_plan`` equal to the JAX ones key for key, its phase counts as the
cadence says; the refreshes' recorded wire bytes are the JAX package's
``wire_nbytes((2, b, chunk / k, hid))`` a block and rank, one float32
scale per row of k and one per row of v; under ``use_cuda_graph`` on the
CPU (the static-buffer step, the shallow phase's graph too) the eager
latent bit for bit.  One JAX compile a config, while the ranks run.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu import pipelines as jax_pipelines
from distrifuser_tpu.models import dit as jax_dit
from distrifuser_tpu.models import mmdit as jax_mm
from distrifuser_tpu.parallel.compress import refresh_period, wire_nbytes
from distrifuser_tpu.parallel.dit_sp import DiTDenoiseRunner as JaxDiTRunner
from distrifuser_tpu.parallel.mmdit_sp import MMDiTDenoiseRunner as JaxMMDiTRunner
from distrifuser_tpu.parallel.stepcache import phase_step_counts
from distrifuser_tpu.schedulers import get_scheduler as jax_scheduler
from distrifuser_tpu_torch.models import dit as port_dit
from distrifuser_tpu_torch.models import mmdit as port_mm
from distrifuser_tpu_torch.models.weights import params_from_jax
from test_torch_port_dit_sp import _inputs as dit_inputs
from test_torch_port_mmdit_sp import _inputs as mm_inputs
from test_torch_port_pixart import _seeded
from test_torch_port_ranks import dit_worker, mmdit_worker, run_ranks
from test_torch_port_sd3 import jax_tree

TOL = 5e-4
WORLD, STEPS = 4, 6
SC = {"step_cache_interval": 2, "step_cache_depth": 1}
PCPP = {"comm_compress": "int8", "refresh_fraction": 0.5}
DIT_CASES = [PCPP, {"comm_compress": "int8_residual"}, {"comm_compress": "fp8"},
             SC, {**SC, "comm_compress": "int8"}]
# the cases run again under use_cuda_graph, by index
DIT_GRAPHED = [0, 3]
# the MMDiTs: (config fields, seed); "dual1" cuts past its one dual block
MMDITS = {"plain": ({"depth": 2}, 40),
          "dual1": ({"depth": 3, "qk_norm": True, "dual_attention_blocks": 1}, 42)}
MM_CASES = [{**SC, **PCPP}, {**SC, **PCPP, "model": "dual1"}]
MM_GRAPHED = [0]


def jax_plan(cfg, runner, steps):
    """The JAX pipelines' ``comm_plan`` of ``runner`` (it reads only the
    config and the runner)."""
    stub = types.SimpleNamespace(distri_config=cfg, runner=runner)
    return jax_pipelines.DistriPixArtPipeline.comm_plan(stub, steps)


def run_dit_cases(n, cases, graphed, devices, tmp, steps=STEPS):
    """The tiny DiT's ``cases`` at n gloo ranks (those of index ``graphed``
    again under ``use_cuda_graph``) and on the JAX mesh of n devices
    (warmup 1, DPM-solver): (every rank's saved results, [(JAX latent,
    comm_report(1), comm_report(2), comm_plan)] a case)."""
    jp, pp = _seeded(port_dit.init_dit_params, port_dit.tiny_dit_config(depth=2), 20)
    latents, enc, mask = dit_inputs()
    torch.save({"cases": cases, "base": {"warmup_steps": 1, "use_cuda_graph": False},
                "graphed": [cases[i] for i in graphed], "params": pp,
                "latents": torch.from_numpy(latents),
                "enc": torch.from_numpy(enc), "mask": torch.from_numpy(mask),
                "steps": steps, "scheduler": "dpm-solver"}, tmp / "dit.pt")
    wait = run_ranks(n, dit_worker, tmp, str(tmp / "dit.pt"), str(tmp / "out"), join=False)
    want = []
    for case in cases:  # the JAX runs while the ranks run
        batch = case.get("batch_size", 1)
        cfg = JaxDistriConfig(devices=devices[:n], height=128, width=128, warmup_steps=1,
                              dtype=jnp.float32, **case)
        runner = JaxDiTRunner(cfg, jax_dit.tiny_dit_config(depth=2), jp,
                              jax_scheduler("dpm-solver"))
        x = runner.generate(jnp.asarray(latents[:batch]), jnp.asarray(enc[:, :batch]),
                            guidance_scale=4.5, num_inference_steps=steps,
                            cap_mask=jnp.asarray(mask[:, :batch]))
        want.append((np.asarray(x), runner.comm_report(1), runner.comm_report(2),
                     jax_plan(cfg, runner, steps)))
    wait()
    return [torch.load(f"{tmp / 'out'}.rank{r}") for r in range(n)], want


def check_cases(n, cases, port, want, steps=STEPS):
    """Each case: the same latent on every rank, within TOL of the JAX one,
    the reports and the plan equal key for key, the phase counts the
    cadence's."""
    for i, case in enumerate(cases):
        x, rep1, rep2, phases, seen = port[0][i]
        for r in range(1, n):
            assert torch.equal(port[r][i][0], x), (case, r)
        want_x, want_rep1, want_rep2, want_plan = want[i]
        err = np.abs(x.numpy() - want_x).max() / np.abs(want_x).max()
        assert err <= TOL, (case, err)
        assert rep1 == want_rep1 and rep2 == want_rep2, (case, rep1, want_rep1)
        assert port[0]["extra", i]["plan"] == want_plan, case
        counts = phase_step_counts(steps, 1, case.get("step_cache_interval", 1))
        if "step_cache_interval" not in case:
            counts.pop("shallow")
        assert phases == counts, (case, phases)
        assert seen == [tuple(want_x.shape)] * steps, case


@pytest.fixture(scope="module")
def dit_world(devices8, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dit_knobs")
    port, want = run_dit_cases(WORLD, DIT_CASES, DIT_GRAPHED, devices8, tmp)
    return port, want


def _seeded_mmdit(name):
    fields, seed = MMDITS[name]
    pcfg = dataclasses.replace(port_mm.tiny_mmdit_config(), **fields)
    jcfg = dataclasses.replace(jax_mm.tiny_mmdit_config(), **fields)
    tree = jax_tree(port_mm.init_mmdit_params(torch.Generator().manual_seed(seed), pcfg))
    rs = np.random.RandomState(seed)  # perturb the unit norms and zero biases
    tree = jax.tree.map(lambda a: a + 0.1 * rs.randn(*a.shape).astype(a.dtype), tree)
    return jcfg, jax.tree.map(jnp.asarray, tree), fields, params_from_jax(tree)


@pytest.fixture(scope="module")
def mm_world(devices8, tmp_path_factory):
    models = {name: _seeded_mmdit(name) for name in MMDITS}
    latents, enc, pooled = mm_inputs()
    tmp = tmp_path_factory.mktemp("mmdit_knobs")
    torch.save({"cases": MM_CASES, "base": {"warmup_steps": 1, "use_cuda_graph": False},
                "graphed": [MM_CASES[i] for i in MM_GRAPHED],
                "models": {k: (v[2], v[3]) for k, v in models.items()},
                "latents": torch.from_numpy(latents), "enc": torch.from_numpy(enc),
                "pooled": torch.from_numpy(pooled), "steps": STEPS}, tmp / "mmdit.pt")
    wait = run_ranks(WORLD, mmdit_worker, tmp, str(tmp / "mmdit.pt"), str(tmp / "out"),
                     join=False)
    want = []
    for case in MM_CASES:
        case = dict(case)
        jcfg, jp, _, _ = models[case.pop("model", "plain")]
        cfg = JaxDistriConfig(devices=devices8[:WORLD], height=256, width=256,
                              warmup_steps=1, dtype=jnp.float32, **case)
        runner = JaxMMDiTRunner(cfg, jcfg, jp, jax_scheduler("flow-euler"))
        x = runner.generate(jnp.asarray(latents[:1]), jnp.asarray(enc[:, :1]),
                            jnp.asarray(pooled[:, :1]), guidance_scale=7.0,
                            num_inference_steps=STEPS)
        want.append((np.asarray(x), runner.comm_report(1), runner.comm_report(2),
                     jax_plan(cfg, runner, STEPS)))
    wait()
    return [torch.load(f"{tmp / 'out'}.rank{r}") for r in range(WORLD)], want


def test_dit_knobs_match_jax(dit_world):
    port, want = dit_world
    check_cases(WORLD, DIT_CASES, port, want)


def test_mmdit_knobs_match_jax(mm_world):
    port, want = mm_world
    check_cases(WORLD, MM_CASES, port, want)


@pytest.mark.parametrize("which", ["dit", "mmdit"])
def test_graphed_equals_eager(which, dit_world, mm_world):
    """``use_cuda_graph=True`` on the CPU (each phase's graph replayed
    without a capture, the shallow one with the deep residual as its
    state) gives the eager latent bit for bit."""
    port, _ = dit_world if which == "dit" else mm_world
    cases = DIT_GRAPHED if which == "dit" else MM_GRAPHED
    for g, i in enumerate(cases):
        assert torch.equal(port[0]["graphed", g][0], port[0][i][0]), i


@pytest.mark.parametrize("i", range(3))
def test_refresh_sends_one_scale_per_k_and_v_row(dit_world, i):
    """The bytes each block's compressed stale refresh put on the wire are
    the JAX package's for ``stack([k, v])`` [2, b, chunk / k, hid]: one
    float32 scale per hid row of k and one per row of v (the UNet's one
    scale per fused 2·hid row would send half the scale bytes)."""
    port, want = dit_world
    case = DIT_CASES[i]
    dcfg = port_dit.tiny_dit_config(depth=2)
    n = WORLD // 2
    chunk = dcfg.num_tokens // n // refresh_period(case.get("refresh_fraction", 1.0))
    per_block = n * wire_nbytes((2, 1, chunk, dcfg.hidden_size), 4, case["comm_compress"])
    wire = port[0]["extra", i]["wire"]["stale"]
    assert wire == {f"blocks.{b}": per_block for b in range(dcfg.depth)}
    rep = want[i][1]
    out_gather = dcfg.num_tokens * dcfg.patch_size ** 2 * dcfg.out_channels * 4
    assert sum(wire.values()) == rep["per_step_collective_bytes"] - out_gather
    assert per_block != n * wire_nbytes((1, chunk, 2 * dcfg.hidden_size), 4,
                                        case["comm_compress"])


def test_shallow_steps_refresh_only_the_kept_blocks(dit_world, mm_world):
    """A shallow step refreshes the blocks before the cut only (the DiT's
    first block; the MMDiT's joint block and, with a dual prefix, the dual
    block's second KV too); the skipped blocks' buffers ride through."""
    port, _ = dit_world
    assert set(port[0]["extra", 4]["wire"]["shallow"]) == {"blocks.0"}
    assert set(port[0]["extra", 4]["wire"]["stale"]) == {"blocks.0", "blocks.1"}
    mm, _ = mm_world
    assert set(mm[0]["extra", 0]["wire"]["shallow"]) == {"blocks.0"}
    assert set(mm[0]["extra", 1]["wire"]["shallow"]) == {"blocks.0", "blocks.1",
                                                         "blocks_dual.0"}


def test_knobs_move_the_latent(dit_world):
    """Each knob changes the result: the compressed refreshes differ from
    one another, and the step cache from the exact run with it."""
    port, _ = dit_world
    xs = [port[0][i][0] for i in range(len(DIT_CASES))]
    for a in range(len(xs)):
        for b in range(a + 1, len(xs)):
            assert not torch.equal(xs[a], xs[b]), (DIT_CASES[a], DIT_CASES[b])
