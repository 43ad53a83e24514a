"""PyTorch port: PipeFusion's knobs against the JAX ``PipeFusionRunner``, the
knob cases of tests/test_pipefusion.py.

At world 2 (2 stages, 2 chunks, no CFG, warmup 1, 6 DDIM steps) on gloo
ranks (tests/test_torch_port_ranks.py ``pipefusion_worker``) and on the
JAX package's fake CPU mesh of 2 devices, from the same seeded tiny DiT
(depth 4), float32: the step cache (interval 2, depth 1 stage); int8, fp8
and int8_residual hops; int8 weights; all of them at once (int8 weights,
int8_residual, the step cache); and warmup-only runs (every step the
mega-patch) without and with every comm knob.  Each latent within its
stated tolerance of the JAX one (``KNOB_TOL``), the same on every rank,
``comm_report`` at batch 1 and 2 and ``comm_plan`` equal to the JAX ones
key for key; the warmup-only runs bit for bit the same with and without
the knobs, on both sides; the JAX byte gates: a steady step's hop bytes
8.25x (raw) and 31.1x (int8) below the displaced patch runner's stale
refresh at depth 4, 2 stages (the port's two ``comm_report``s).
"""

import numpy as np
import pytest
import torch

from distrifuser_tpu_torch.models import dit as port_dit
from test_torch_port_pipefusion import (COMPRESSED_TOL, DEPTH, NO_CFG, RUN, expected_ticks,
                                        run_world)
from test_torch_port_pixart import _seeded

BASE = {**RUN, **NO_CFG, "warmup_steps": 1, "steps": 6}
SC = {"step_cache_interval": 2, "step_cache_depth": 1}
WARM_ONLY = {**BASE, "warmup_steps": 9, "steps": 3}
CASES = [
    BASE,
    {**BASE, **SC},
    {**BASE, "comm_compress": "int8"},
    {**BASE, "comm_compress": "fp8"},
    {**BASE, "comm_compress": "int8_residual"},
    {**BASE, "weight_quant": "int8"},
    {**BASE, **SC, "weight_quant": "int8", "comm_compress": "int8_residual"},
    WARM_ONLY,
    {**WARM_ONLY, **SC, "comm_compress": "int8_residual"},
]
# the latent's largest difference to the JAX one, in units of the JAX
# latent's largest magnitude: float32 rounding where every value travels
# exactly; one payload step (1/127 of a row's largest value, e4m3's 2^-4
# relative) where a row quantizes to another step in the two frameworks
# relative (e4m3 has 3 mantissa bits: one step is up to 1/16 of a value)
KNOB_TOL = [5e-4, 5e-4, COMPRESSED_TOL, 5e-2, COMPRESSED_TOL, 5e-4, COMPRESSED_TOL, 5e-4,
            5e-4]


@pytest.fixture(scope="module")
def knobs(devices8, tmp_path_factory):
    params = _seeded(port_dit.init_dit_params, port_dit.tiny_dit_config(depth=DEPTH), 20)
    return run_world(2, CASES, devices8, tmp_path_factory.mktemp("pfk"), params,
                     patch_report=BASE)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_knob_matches_jax(knobs, i):
    port, want = knobs
    case = CASES[i]
    x, rep1, rep2, ticks, plan = port[0][i]
    assert torch.equal(port[1][i][0], x), case
    want_x, want_rep1, want_rep2, want_plan = want[i]
    err = np.abs(x.numpy() - want_x).max() / np.abs(want_x).max()
    assert err <= KNOB_TOL[i], (case, err)
    assert rep1 == want_rep1 and rep2 == want_rep2, (case, rep1, want_rep1)
    assert plan == want_plan, (case, plan, want_plan)
    for r in range(2):
        assert port[r][i][3] == expected_ticks(case, 2, r), (case, r)


def test_warmup_only_knobs_bit_identical(knobs):
    """Warmup hops never compress and a warmup pass is never shallow: the
    knobs change nothing, in the port and in the JAX package."""
    port, want = knobs
    assert torch.equal(port[0][7][0], port[0][8][0])
    np.testing.assert_array_equal(want[7][0], want[8][0])


def test_hop_bytes_below_the_patch_refresh(knobs):
    """The JAX byte gate (scripts/bench_pipefusion.py): a steady step's hop
    bytes against the displaced patch runner's stale refresh at depth 4 and
    2 ranks, no CFG: 8.25x raw, 31.1x with int8 hops (>= 1.5x, the gate)."""
    port, _ = knobs
    patch = port[0]["patch_report"]["per_step_collective_bytes"]
    ratios = [patch / port[0][i][1]["per_step_collective_bytes"] for i in (0, 2)]
    assert ratios[0] == 8.25 and round(ratios[1], 1) == 31.1, ratios
