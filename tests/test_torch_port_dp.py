"""PyTorch port: data parallelism over image groups (``dp_degree``).

* The rank layout and the validation of tests/test_dp.py: at world 8 with
  dp 2 the image groups hold 4 ranks each (CFG 2 x sp 2) with the JAX
  mesh's ``dp_idx`` / ``batch_idx`` / ``split_idx``, and the process groups
  are the JAX mesh's rows (``reshape(dp, cfg, n)``); a batch or a world that
  dp does not divide is refused with the JAX package's exception and
  message.
* The tiny SD runner at dp 2 on 4 gloo ranks (tests/test_torch_port_ranks.py
  ``dp_worker``; each image group sp 2, or CFG 2 x sp 1) gives, on every
  rank, both images equal bit for bit to two independent 2-rank runs of
  one image each, and its callback sees the whole batch; at sp 2 it
  agrees with the JAX runner at the same layout (dp 2 x sp 2 on 4 fake
  CPU devices, same weights and inputs) within 5e-4 of the largest
  magnitude, as tests/test_torch_port_patch_runner.py holds the patch
  runner.
* The tiny SD pipeline at dp 2 x sp 2 returns both prompts' latents and
  images on every rank, equal to each prompt's own 2-rank call.
"""

import numpy as np
import pytest
import torch

from distrifuser_tpu import DistriConfig as JaxDistriConfig
from distrifuser_tpu.models import unet as jax_unet
from distrifuser_tpu.parallel.runner import make_runner as make_jax_runner
from distrifuser_tpu.schedulers import get_scheduler
from distrifuser_tpu_torch.utils import config as config_mod
from test_torch_port_ranks import dp_worker, jax_layout, run_ranks

REL = 5e-4
DP = {"dp_degree": 2, "batch_size": 2}
SP2 = {"split_batch": False}
LAYOUTS = {"sp2": SP2, "cfg2": {}}  # each image group: sp 2, or CFG 2 x sp 1
PROMPTS = ["a cat", "a dog"]


def _fake_world(monkeypatch, world, rank=0):
    monkeypatch.setattr(config_mod, "_world_and_rank", lambda: (world, rank))
    monkeypatch.setattr(config_mod, "_process_groups", lambda w, n, r, dp: (None, None, None))


def test_dp_rank_layout(devices8, monkeypatch):
    jcfg = JaxDistriConfig(devices=devices8, height=128, width=128, **DP)
    _fake_world(monkeypatch, 8)
    cfg = config_mod.DistriConfig(device="cpu", height=128, width=128, **DP)
    assert (cfg.group_size, cfg.n_device_per_batch) == (jcfg.group_size,
                                                        jcfg.n_device_per_batch) == (4, 2)
    for fn in ("dp_idx", "batch_idx", "split_idx"):
        assert ([getattr(cfg, fn)(r) for r in range(8)]
                == [getattr(jcfg, fn)(r) for r in range(8)]), fn
    assert [cfg.dp_idx(r) for r in range(8)] == [0, 0, 0, 0, 1, 1, 1, 1]
    assert [cfg.batch_idx(r) for r in range(8)] == [0, 0, 1, 1, 0, 0, 1, 1]
    assert cfg.cfg_split == jcfg.cfg_split


@pytest.mark.parametrize("split_batch", [True, False])
def test_dp_process_groups_are_the_mesh_rows(devices8, monkeypatch, split_batch):
    """Each rank's batch, split and dp groups hold the ranks of its row of
    the JAX mesh along sp, cfg and dp; every rank creates every group in
    one order."""
    created = []

    def new_group(ranks):
        created.append(tuple(ranks))
        return tuple(ranks)

    monkeypatch.setattr(config_mod.dist, "new_group", new_group)
    monkeypatch.setattr(config_mod, "_GROUPS", {})
    jcfg = JaxDistriConfig(devices=devices8, height=128, width=128,
                           split_batch=split_batch, **DP)
    mesh = np.array([d.id for d in jcfg.mesh.devices.flat]).reshape(jcfg.mesh.devices.shape)
    ids = [d.id for d in devices8]
    orders = []
    for rank in range(8):
        monkeypatch.setattr(config_mod, "_world_and_rank", lambda r=rank: (8, r))
        created.clear()
        config_mod._GROUPS.clear()
        cfg = config_mod.DistriConfig(device="cpu", height=128, width=128,
                                      split_batch=split_batch, **DP)
        orders.append(list(created))
        d, c, s = (int(i[0]) for i in np.nonzero(mesh == ids[rank]))
        row = lambda v: tuple(ids.index(i) for i in v)  # noqa: E731
        assert cfg.batch_group == row(mesh[d, c, :])
        assert cfg.split_group == (row(mesh[d, :, s]) if jcfg.cfg_split else None)
        assert cfg.dp_group == row(mesh[:, c, s])
    assert all(order == orders[0] for order in orders)


@pytest.mark.parametrize("fields", [
    {"dp_degree": 2, "batch_size": 1},
    {"dp_degree": 3, "batch_size": 3},
    {"dp_degree": 0},
    {"dp_degree": 16, "batch_size": 16},
])
def test_dp_validation_matches_jax(devices8, monkeypatch, fields):
    with pytest.raises(ValueError) as want:
        JaxDistriConfig(devices=devices8, **fields)
    _fake_world(monkeypatch, 8)
    with pytest.raises(ValueError) as got:
        config_mod.DistriConfig(device="cpu", **fields)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def runs(devices8, tmp_path_factory):
    """Every rank's results at world 4 (dp 2) and world 2 (each image
    alone), and the JAX runner's latents at dp 2 x sp 2."""
    from distrifuser_tpu_torch.models import unet, vae

    ucfg = unet.tiny_config(cross_attention_dim=32)
    params = unet.init_unet_params(torch.Generator().manual_seed(0), ucfg)
    rs = np.random.RandomState(5)
    latents = rs.randn(2, 16, 16, 4).astype(np.float32)
    enc = rs.randn(2, 2, 7, 32).astype(np.float32)
    vae_params = vae.init_vae_params(torch.Generator().manual_seed(1), vae.tiny_vae_config())
    tmp = tmp_path_factory.mktemp("dp")
    spec = {
        4: {"runs": [({**DP, **LAYOUTS[k]}, [0, 1]) for k in LAYOUTS],
            "pipelines": [({**DP, **SP2}, PROMPTS, [0, 1])]},
        2: {"runs": [(LAYOUTS[k], [i]) for k in LAYOUTS for i in (0, 1)],
            "pipelines": [(SP2, [p], [i]) for i, p in enumerate(PROMPTS)]},
    }
    out = {}
    for world, cases in spec.items():
        torch.save({**cases, "params": params, "vae": vae_params,
                    "latents": torch.from_numpy(latents), "enc": torch.from_numpy(enc)},
                   tmp / f"in{world}.pt")
        run_ranks(world, dp_worker, tmp, str(tmp / f"in{world}.pt"), str(tmp / f"out{world}"))
        out[world] = [torch.load(f"{tmp / f'out{world}'}.rank{r}") for r in range(world)]
    jcfg = JaxDistriConfig(devices=devices8[:4], height=128, width=128, warmup_steps=1,
                           **DP, **SP2)
    jrunner = make_jax_runner(jcfg, jax_unet.tiny_config(cross_attention_dim=32),
                              jax_layout(params), get_scheduler("ddim"))
    out["jax"] = np.asarray(jrunner.generate(latents, enc, num_inference_steps=4,
                                             guidance_scale=5.0))
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_dp_equals_independent_runs(runs, layout):
    i = list(LAYOUTS).index(layout)
    alone = [runs[2][0][("run", 2 * i + img)][0] for img in (0, 1)]
    for rank in runs[4]:
        x, seen, phases = rank[("run", i)]
        assert torch.equal(x, torch.cat(alone)), layout
        assert seen == [tuple(x.shape)] * 4
        assert phases == ({"sync": 2, "stale": 2} if layout == "sp2"
                          else {"sync": 4, "stale": 0})


def test_dp_matches_jax_runner(runs):
    want = runs["jax"]
    for rank in runs[4]:
        got = rank[("run", 0)][0].numpy()
        assert np.abs(got - want).max() <= REL * np.abs(want).max()


@pytest.mark.parametrize("kind", ["latent", "np"])
def test_dp_pipeline_returns_every_image(runs, kind):
    k = ["latent", "np"].index(kind)
    alone = torch.cat([runs[2][0][("pipeline", i)][k] for i in (0, 1)])
    assert alone.shape[0] == len(PROMPTS) and torch.isfinite(alone).all()
    for rank in runs[4]:
        assert torch.equal(rank[("pipeline", 0)][k], alone)
