"""PyTorch port: the DiT's head-sharded layouts, "ulysses" and "usp"
(ops/ulysses.py, parallel/dit_sp.py), against the JAX
``DiTDenoiseRunner`` at the same n.

At world 4 on gloo ranks and on the JAX package's fake CPU mesh of 4
devices, the tiny DiT (``tiny_dit_config(depth=2)``, 4 heads), warmup 1, 6
DPM-solver steps:

* ulysses at CFG 2 x sp 2 (the all-to-all over the two patch ranks) and
  at sp 4 with the CFG branches folded;
* usp at sp 4, folded, with ``ulysses_degree`` 1 (the exact ring alone),
  2 (an all-to-all over pairs, a ring over pairs) and 4 (the all-to-all
  alone);
* ulysses with the step cache (interval 2, depth 1): the shallow steps'
  only state is the deep residual;

each latent within 5e-4 of the JAX one's largest value, the same on every
rank, its ``comm_report`` at batch 1 and 2 and ``comm_plan`` equal to the
JAX ones key for key, its phase counts as expected (sync then stale: the
layouts keep no KV, so the stale steps compute what synchronous ones do),
two all-to-alls a block and step (none at ``ulysses_degree`` 1); under
``use_cuda_graph`` on the CPU the eager latent bit for bit.  The
refusals of the JAX package (heads the group does not divide, a
``ulysses_degree`` outside usp or not dividing sp, the head-sharded
layouts on the UNet and the MMDiT, the gather refresh's knobs with them)
run in this process, against the JAX package's own.
"""

import dataclasses

import pytest
import torch

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.models import dit as jax_dit
from distrifuser_tpu.parallel.dit_sp import DiTDenoiseRunner as JaxDiTRunner
from distrifuser_tpu.schedulers import get_scheduler as jax_scheduler
from distrifuser_tpu_torch.models import dit as port_dit
from distrifuser_tpu_torch.models import mmdit as port_mm
from distrifuser_tpu_torch.models import unet as port_unet
from distrifuser_tpu_torch.parallel.dit_sp import DiTDenoiseRunner
from distrifuser_tpu_torch.parallel.mmdit_sp import MMDiTDenoiseRunner
from distrifuser_tpu_torch.parallel.runner import DenoiseRunner
from distrifuser_tpu_torch.schedulers import get_scheduler
from distrifuser_tpu_torch.utils.config import DistriConfig
from test_torch_port_transformer_knobs import SC, WORLD, check_cases, run_dit_cases

FOLDED = {"split_batch": False}
CASES = [{"attn_impl": "ulysses"}, {"attn_impl": "ulysses", **FOLDED},
         {"attn_impl": "usp", "ulysses_degree": 1, **FOLDED},
         {"attn_impl": "usp", "ulysses_degree": 2, **FOLDED},
         {"attn_impl": "usp", "ulysses_degree": 4, **FOLDED},
         {"attn_impl": "ulysses", **SC}]
GRAPHED = [0, 3, 5]  # the cases run again under use_cuda_graph, by index


@pytest.fixture(scope="module")
def world(devices8, tmp_path_factory):
    return run_dit_cases(WORLD, CASES, GRAPHED, devices8, tmp_path_factory.mktemp("ulysses"))


def test_head_sharded_layouts_match_jax(world):
    port, want = world
    check_cases(WORLD, CASES, port, want)


@pytest.mark.parametrize("g,i", list(enumerate(GRAPHED)))
def test_graphed_equals_eager(world, g, i):
    """``use_cuda_graph=True`` on the CPU gives the eager latent bit for
    bit: ulysses (stateless: its stale graph reads no buffers), usp, and
    ulysses with the step cache (the shallow graph reads the deep
    residual)."""
    port, _ = world
    assert torch.equal(port[0]["graphed", g][0], port[0][i][0]), CASES[i]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_all_to_alls_per_step(world, i):
    """Two all-to-alls a block and evaluated step (q, k and v in one, the
    output back in the other), over the group of the head shard; none
    where ``ulysses_degree`` is 1.  The layouts keep no stale KV and
    refresh nothing."""
    port, _ = world
    case = CASES[i]
    dcfg = port_dit.tiny_dit_config(depth=2)
    phases = port[0][i][3]
    blocks = dcfg.depth * (phases["sync"] + phases["stale"]) + (
        phases.get("shallow", 0) * (dcfg.depth - case.get("step_cache_depth", 0)))
    want = 0 if case.get("ulysses_degree") == 1 else 2 * blocks
    for r in range(WORLD):
        assert port[r]["extra", i]["a2a"] == want, (case, r)
        assert all(not wire for wire in port[r]["extra", i]["wire"].values()), case
    assert port[0][i][1]["kv_state_elems"] == 0


def _cfg(**fields):
    return DistriConfig(device="cpu", **{"height": 128, "width": 128, **fields})


def _jax_cfg(devices, n, **fields):
    return JaxDistriConfig(devices=devices[:n], **{"height": 128, "width": 128, **fields})


@pytest.mark.parametrize("fields,n,match", [
    ({"attn_impl": "ulysses"}, 8, "num_heads"),  # 4 heads over sp 8
    ({"attn_impl": "usp", "ulysses_degree": 8}, 8, "num_heads"),
    ({"attn_impl": "ulysses", "comm_compress": "int8"}, 2, "comm_compress"),
    ({"attn_impl": "usp", "refresh_fraction": 0.5}, 2, "refresh_fraction"),
])
def test_dit_runner_refusals(devices8, fields, n, match):
    """The DiT runner's ValueErrors, the JAX runner's own: heads that the
    head shard's group does not divide, and the gather refresh's knobs
    with a head-sharded layout (one config of n patch ranks each)."""
    jcfg = _jax_cfg(devices8, n, split_batch=False, **fields)
    with pytest.raises(ValueError, match=match):
        JaxDiTRunner(jcfg, jax_dit.tiny_dit_config(depth=2), {}, jax_scheduler("ddim"))
    cfg = _cfg(**{**fields, "ulysses_degree": 1})
    cfg.n_device_per_batch, cfg.ulysses_degree = n, fields.get("ulysses_degree", 1)
    with pytest.raises(ValueError, match=match):
        DiTDenoiseRunner(cfg, port_dit.tiny_dit_config(depth=2), {}, get_scheduler("ddim"))


@pytest.mark.parametrize("fields,n,match", [
    ({"ulysses_degree": 2}, 2, "'usp' only"),
    ({"attn_impl": "ring", "ulysses_degree": 2}, 2, "'usp' only"),
    ({"attn_impl": "usp", "ulysses_degree": 4}, 2, "must divide the sp degree"),
])
def test_config_refusals(devices8, fields, n, match):
    """``DistriConfig``'s ValueErrors, the JAX config's own: a
    ``ulysses_degree`` outside usp, or one that does not divide the patch
    group (here the JAX mesh's sp 2, the port's one rank)."""
    with pytest.raises(ValueError, match=match):
        _jax_cfg(devices8, n, split_batch=False, **fields)
    with pytest.raises(ValueError, match=match):
        _cfg(**fields)


@pytest.mark.parametrize("attn_impl", ["ulysses", "usp"])
def test_other_runners_refuse_head_sharding(attn_impl):
    """The UNet's and the MMDiT's runners refuse the DiT's layouts with the
    JAX runners' ValueErrors; the config itself accepts them."""
    cfg = _cfg(attn_impl=attn_impl)
    with pytest.raises(ValueError, match="DiT strategy"):
        DenoiseRunner(cfg, port_unet.tiny_config(), {}, get_scheduler("ddim"))
    mcfg = dataclasses.replace(port_mm.tiny_mmdit_config(), depth=2)
    mm_cfg = DistriConfig(device="cpu", height=256, width=256, attn_impl=attn_impl)
    with pytest.raises(ValueError, match="joint"):
        MMDiTDenoiseRunner(mm_cfg, mcfg, {}, get_scheduler("flow-euler"))


def test_comm_report_rows_at_batch_2(world):
    """The ulysses and usp rows of ``comm_report`` at two images equal the
    JAX closed form (checked key for key above) and scale with the batch:
    the all-to-alls move the local tokens' q, k, v and output, the usp ring
    (r - 1) hops of the head shard's KV."""
    port, want = world
    for i in range(len(CASES)):
        rep1, rep2 = port[0][i][1], port[0][i][2]
        assert rep2 == want[i][2]
        assert rep2["per_step_collective_elems"] == 2 * rep1["per_step_collective_elems"]
        assert rep1["layout"] == CASES[i]["attn_impl"]
