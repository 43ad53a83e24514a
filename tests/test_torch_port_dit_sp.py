"""PyTorch port: the DiT's displaced patch parallelism (parallel/dit_sp.py)
against the JAX ``DiTDenoiseRunner`` at the same n.

The tiny DiT (``tiny_dit_config(depth=2)``, a 16x16 latent, 7 caption
tokens with a mask) runs 4 DPM-solver steps on 2 and 4 gloo ranks (the
workers in tests/test_torch_port_ranks.py) and on the JAX package's fake
CPU mesh of as many devices, from the same seeded weights and inputs:

* world 2, sp 2 with the CFG branches folded: "gather" and "ring" with
  warmup 1 (2 synchronous, 2 stale steps) and "gather" under ``full_sync``
  (every step synchronous);
* world 4, CFG 2 x sp 2 (split): "gather" and "ring" with warmup 1, both
  under ``no_sync`` (the warmup's buffers kept), and ``dp_degree=2`` (two
  image groups of sp 2, two images);

each latent within 5e-4 of the JAX one's largest value, the same on every
rank, its ``comm_report`` equal to the JAX one's key for key at batch 1 and
2, its phase counts and the callback's latent shapes as expected.  The
refusals (the JAX runner's ValueErrors, and ``parallelism="pipefusion"``,
which parallel/pipefusion.py runs) run in this process.  The comm knobs
and the head-sharded layouts are held in
tests/test_torch_port_transformer_knobs.py and _ulysses.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.models import dit as jax_dit
from distrifuser_tpu.parallel.dit_sp import DiTDenoiseRunner as JaxDiTRunner
from distrifuser_tpu.schedulers import get_scheduler as jax_scheduler
from distrifuser_tpu_torch.models import dit as port_dit
from distrifuser_tpu_torch.parallel.dit_sp import DiTDenoiseRunner
from distrifuser_tpu_torch.schedulers import get_scheduler
from distrifuser_tpu_torch.utils.config import DistriConfig
from test_torch_port_pixart import _seeded
from test_torch_port_ranks import dit_worker, run_ranks

TOL = 5e-4
STEPS = 4
SCHEDULER = "dpm-solver"
FOLDED = {"split_batch": False}
CASES = {
    2: [{"attn_impl": "gather", **FOLDED}, {"attn_impl": "ring", **FOLDED},
        {"mode": "full_sync", **FOLDED}],
    4: [{"attn_impl": "gather"}, {"attn_impl": "ring"},
        {"attn_impl": "gather", "mode": "no_sync"}, {"attn_impl": "ring", "mode": "no_sync"},
        {"dp_degree": 2, "batch_size": 2, **FOLDED}],
}


def _inputs():
    rs = np.random.RandomState(21)
    latents = rs.randn(2, 16, 16, 4).astype(np.float32)
    enc = rs.randn(2, 2, 7, 32).astype(np.float32)
    mask = np.ones((2, 2, 7), np.float32)
    mask[:, 0, 4:] = 0
    mask[0, 1, 6:] = 0
    return latents, enc, mask


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, devices8, tmp_path_factory):
    n = request.param
    jp, pp = _seeded(port_dit.init_dit_params, port_dit.tiny_dit_config(depth=2), 20)
    latents, enc, mask = _inputs()
    tmp = tmp_path_factory.mktemp(f"dit{n}")
    torch.save({"cases": CASES[n], "base": {"warmup_steps": 1, "use_cuda_graph": False},
                "graphed": CASES[n][:2],
                "params": pp, "latents": torch.from_numpy(latents),
                "enc": torch.from_numpy(enc), "mask": torch.from_numpy(mask),
                "steps": STEPS, "scheduler": SCHEDULER}, tmp / "dit.pt")
    wait = run_ranks(n, dit_worker, tmp, str(tmp / "dit.pt"), str(tmp / "out"), join=False)
    want = []
    for case in CASES[n]:  # the JAX runs while the ranks run
        batch = case.get("batch_size", 1)
        cfg = JaxDistriConfig(devices=devices8[:n], height=128, width=128, warmup_steps=1,
                              dtype=jnp.float32, **case)
        runner = JaxDiTRunner(cfg, jax_dit.tiny_dit_config(depth=2), jp,
                              jax_scheduler(SCHEDULER))
        x = runner.generate(jnp.asarray(latents[:batch]), jnp.asarray(enc[:, :batch]),
                            guidance_scale=4.5, num_inference_steps=STEPS,
                            cap_mask=jnp.asarray(mask[:, :batch]))
        want.append((np.asarray(x), runner.comm_report(1), runner.comm_report(2)))
    wait()
    port = [torch.load(f"{tmp / 'out'}.rank{r}") for r in range(n)]
    return n, port, want


def test_runner_matches_jax(world):
    n, port, want = world
    for i, case in enumerate(CASES[n]):
        x, rep1, rep2, phases, seen = port[0][i]
        for r in range(1, n):
            assert torch.equal(port[r][i][0], x), (case, r)
        want_x, want_rep1, want_rep2 = want[i]
        err = np.abs(x.numpy() - want_x).max() / np.abs(want_x).max()
        assert err <= TOL, (case, err)
        assert rep1 == want_rep1 and rep2 == want_rep2, case
        sync = STEPS if case.get("mode") == "full_sync" else 2
        assert phases == {"sync": sync, "stale": STEPS - sync}, case
        assert seen == [tuple(want_x.shape)] * STEPS, case


def test_graphed_runner_equals_eager(world):
    """``use_cuda_graph=True`` on the CPU (the static-buffer step, each
    phase's graph replayed without a capture) gives the eager latent bit
    for bit, in both layouts."""
    n, port, _ = world
    for i, case in enumerate(CASES[n][:2]):
        assert torch.equal(port[0]["graphed", i][0], port[0][i][0]), case


def test_stale_steps_move_the_latent(world):
    """The stale phase changes the result (it is not the synchronous run),
    and no_sync differs from the refreshing run."""
    n, port, _ = world
    if n == 2:
        gather, _, full = (port[0][i][0] for i in range(3))
        assert not torch.equal(gather, full)
    else:
        assert not torch.equal(port[0][0][0], port[0][2][0])
        assert not torch.equal(port[0][1][0], port[0][3][0])


def _cfg(**fields):
    return DistriConfig(device="cpu", **{"height": 128, "width": 128, **fields})


@pytest.mark.parametrize("fields,exc,match", [
    ({"comm_batch": True}, ValueError, "comm_batch"),
    ({"attn_impl": "ring", "comm_compress": "int8"}, ValueError, "comm_compress"),
    ({"attn_impl": "ring", "refresh_fraction": 0.5}, ValueError, "refresh_fraction"),
    ({"height": 256, "width": 256}, ValueError, "sample_size"),
    ({"parallelism": "tensor"}, ValueError, "parallelism"),
    ({"attn_impl": "ulysses", "comm_compress": "int8"}, ValueError, "comm_compress"),
    ({"attn_impl": "usp", "refresh_fraction": 0.5}, ValueError, "refresh_fraction"),
    ({"step_cache_interval": 2, "step_cache_depth": 2}, ValueError, "step_cache_depth"),
    ({"parallelism": "pipefusion"}, ValueError, "PipeFusionRunner"),
])
def test_runner_refusals(fields, exc, match):
    dcfg = port_dit.tiny_dit_config(depth=2)
    with pytest.raises(exc, match=match):
        DiTDenoiseRunner(_cfg(**fields), dcfg, {}, get_scheduler("ddim"))


@pytest.mark.parametrize("fields,match", [
    ({"attn_impl": "ulysses"}, None), ({"attn_impl": "usp"}, None),
    ({"ulysses_degree": 2}, "'usp' only"),
    ({"pipe_patches": 4}, "no pipeline to stream patches through"),
])
def test_config_refuses_later_dit_layouts(fields, match):
    """The head-sharded layouts are accepted (tests/test_torch_port_ulysses.py
    runs them); a ``ulysses_degree`` outside usp and ``pipe_patches``
    outside PipeFusion (tests/test_torch_port_pipefusion.py) are the JAX
    config's ValueErrors."""
    if match is None:
        assert _cfg(**fields).attn_impl == fields["attn_impl"]
        return
    with pytest.raises(ValueError, match=match):
        _cfg(**fields)


def test_jax_runner_refuses_the_same(devices8):
    """The ValueErrors above are the JAX runner's own."""
    dcfg = jax_dit.tiny_dit_config(depth=2)
    for fields in ({"comm_batch": True}, {"attn_impl": "ring", "comm_compress": "int8"},
                   {"height": 256, "width": 256}):
        cfg = JaxDistriConfig(devices=devices8[:2], **{"height": 128, "width": 128, **fields})
        with pytest.raises(ValueError):
            JaxDiTRunner(cfg, dcfg, {}, jax_scheduler("ddim"))


def test_dense_runner_equals_dit_forward():
    """One device, CFG folded: the runner's first DDIM step is the dense
    forward's guided epsilon through the scheduler."""
    dcfg = port_dit.tiny_dit_config(depth=2)
    params = port_dit.init_dit_params(torch.Generator().manual_seed(22), dcfg)
    latents, enc, mask = (torch.from_numpy(a) for a in _inputs())
    sched = get_scheduler("ddim")
    runner = DiTDenoiseRunner(_cfg(use_cuda_graph=False), dcfg, params, sched)
    got = runner.generate(latents[:1], enc[:, :1], guidance_scale=4.5,
                          num_inference_steps=1, cap_mask=mask[:, :1])
    sched.set_timesteps(1)
    t = sched.timesteps()[0]
    eps = port_dit.dit_forward(params, dcfg, torch.cat([latents[:1]] * 2), t,
                               enc[:, :1].reshape(2, 7, 32), cap_mask=mask[:, :1].reshape(2, 7))
    guided = eps[:1] + 4.5 * (eps[1:] - eps[:1])
    want, _ = sched.step(latents[:1], guided, 0, sched.init_state(latents[:1].shape))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
