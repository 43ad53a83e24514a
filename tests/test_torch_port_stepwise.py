"""PyTorch port: the explicit-carry stepwise API and the step-by-step
classification against the JAX package.

* ``_stepwise_phase`` (which phase, and whether shallow, each step of a run
  takes) and ``stepwise_carry_signature`` equal the JAX package's over a
  grid of sync modes, warmups, step-cache cadences, step counts and start
  steps, at one rank and at two (sp 2);
* at 2 gloo ranks (sp 2, warmup 1, 6 DDIM steps) two carries stepped
  interleaved give the latents of the same carries stepped one after the
  other and of ``generate``, bit for bit: plain, the step cache with int8
  residual coding and a partial refresh (eager, and on the CPU static-buffer
  graph path) and ring attention.
"""

import itertools

import numpy as np
import pytest
import torch

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.models import unet as jax_unet
from distrifuser_tpu.parallel.runner import DenoiseRunner as JaxDenoiseRunner
from distrifuser_tpu.schedulers import get_scheduler
from distrifuser_tpu_torch.models import unet as port_unet
from distrifuser_tpu_torch.parallel.runner import DenoiseRunner
from distrifuser_tpu_torch.schedulers import get_scheduler as port_scheduler
from distrifuser_tpu_torch.utils import config as config_mod
from test_torch_port_ranks import run_ranks, stepwise_worker

WORLD = 2
STEPS = 6
CARRY_CASES = [
    {},
    {"step_cache_interval": 2, "step_cache_depth": 1, "refresh_fraction": 0.5,
     "comm_compress": "int8_residual"},
    {"step_cache_interval": 2, "step_cache_depth": 1, "refresh_fraction": 0.5,
     "comm_compress": "int8_residual", "use_cuda_graph": True},
    {"attn_impl": "ring"},
]


@pytest.mark.parametrize("world", [1, 2])
def test_stepwise_phase_and_signature_match_jax(devices8, monkeypatch, world):
    # the classification reads the config alone: no weights needed
    ucfg = jax_unet.tiny_config(cross_attention_dim=32, sdxl=True)
    if world > 1:
        monkeypatch.setattr(config_mod, "_world_and_rank", lambda: (world, 0))
        monkeypatch.setattr(config_mod, "_process_groups", lambda w, n, r, dp: (None, None, None))
    for mode, warmup, (interval, depth) in itertools.product(
            ("full_sync", "stale_gn"), (0, 1, 3), ((1, 0), (2, 1), (3, 1))):
        fields = dict(height=128, width=128, split_batch=False, mode=mode,
                      warmup_steps=warmup, step_cache_interval=interval,
                      step_cache_depth=depth)
        jrunner = JaxDenoiseRunner(JaxDistriConfig(devices=devices8[:world], **fields),
                                   ucfg, {}, get_scheduler("ddim"))
        runner = DenoiseRunner(config_mod.DistriConfig(device="cpu", **fields), ucfg,
                               {}, port_scheduler("ddim"))
        assert runner.cfg.is_sp == (world > 1)
        for steps in range(1, 8):
            for start in range(steps):
                for i in range(start, steps):
                    assert (runner._stepwise_phase(i, start, steps)
                            == jrunner._stepwise_phase(i, start, steps)), (fields, i)
            jcarry = jrunner.stepwise_carry_init(np.zeros((1, 16, 16, 4), np.float32), steps)
            carry = runner.stepwise_carry_init(torch.zeros(1, 16, 16, 4), steps)
            assert carry[1] is None and jcarry[1] is None
            for i in range(steps):
                assert (runner.stepwise_carry_signature(carry, i, steps)
                        == jrunner.stepwise_carry_signature(jcarry, i, steps))


@pytest.fixture(scope="module")
def carries(tmp_path_factory):
    # a port-only comparison: the port's own seeded tree
    ucfg = port_unet.tiny_config(cross_attention_dim=32, sdxl=True)
    params = port_unet.init_unet_params(torch.Generator().manual_seed(0), ucfg)
    rs = np.random.RandomState(4)
    f = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))  # noqa: E731
    tmp = tmp_path_factory.mktemp("stepwise")
    torch.save({"cases": CARRY_CASES, "steps": STEPS,
                "base": {"split_batch": False, "warmup_steps": 1, "use_cuda_graph": False},
                "params": params,
                "latents": [f(1, 16, 16, 4), f(1, 16, 16, 4)], "enc": f(2, 1, 7, 32),
                "added": {"text_embeds": f(2, 1, 32),
                          "time_ids": torch.tensor([128.0, 128, 0, 0, 128, 128]).repeat(
                              2, 1, 1)}},
               tmp / "stepwise.pt")
    run_ranks(WORLD, stepwise_worker, tmp, str(tmp / "stepwise.pt"), str(tmp / "out"))
    return [torch.load(f"{tmp / 'out'}.rank{r}") for r in range(WORLD)]


@pytest.mark.parametrize("case", CARRY_CASES,
                         ids=["plain", "stepcache_pcpp_residual", "graphed", "ring"])
def test_interleaved_carries_equal_contiguous_runs(carries, case):
    key = tuple(sorted(case.items()))
    for r in range(WORLD):
        got = carries[r][key]
        for a, b, g in zip(got["interleaved"], got["contiguous"], got["generate"]):
            assert torch.equal(a, b)
            assert torch.equal(a, g)
        assert not torch.equal(got["interleaved"][0], got["interleaved"][1])
        assert torch.equal(got["interleaved"][0], carries[0][key]["interleaved"][0])
        shallow = [s[3] for s in got["signatures"]]
        assert any(shallow) == ("step_cache_interval" in case)
    # the graph path replays the eager evaluations
    plain = tuple(sorted(CARRY_CASES[1].items()))
    graphed = tuple(sorted(CARRY_CASES[2].items()))
    assert torch.equal(carries[0][plain]["interleaved"][0],
                       carries[0][graphed]["interleaved"][0])
