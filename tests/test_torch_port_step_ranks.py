"""PyTorch port: serving over n ranks (serve/ranks.py) at 4 gloo ranks.

One spawn of four ranks (tests/test_torch_port_ranks.py
``step_ranks_worker``), each case under a time limit of its own:

* the collective fakes' order cases (whole-batch, staged with two batches
  in flight, step rounds with a join and with a preemption), as
  tests/test_torch_port_serve_ranks.py runs them at two ranks;
* the port's counterpart of tests/test_stepbatch.py
  ``test_real_pipeline_mixed_signature_groups``: the tiny SD pipeline at
  CFG 2 x sp 2 (warmup 1, 3 DDIM steps) behind a `RankedExecutor` on rank 0
  whose every step operation runs on the four ranks, rank 0 planning each
  round's packing.  A request at its stale step and two fresh ones step in
  two dispatches with three packed rows, and every image equals its solo
  run's bit for bit, and is within ``SDXL_TOL`` of the JAX package's step
  run over a 4-device fake mesh on the same weights and latents (its solo
  runs: the JAX test holds its packed runs to them bit for bit);
* a step carry across a rebuild of the data groups (queue 3 fault 9): one
  slot, a slack request preempted (its carry parked) by a tight one whose
  ``step_begin`` fails on rank 1 alone between the collective fake's two
  group operations; every rank makes the data groups anew, and the parked
  carry resumes on its key's rebuilt executor and finishes at its solo
  bits.
"""

import numpy as np
import pytest
import torch

from test_torch_port_ranks import _seeded_latents, jax_layout, run_ranks, step_ranks_worker
from test_torch_port_serve_pipeline import SDXL_TOL

WORLD, STEPS = 4, 3
REQUESTS = [("a cat", 7), ("a dog", 9), ("a fox", 11)]


def _trees():
    """The tiny SD pipeline's trees, seeded with the port's init."""
    from distrifuser_tpu_torch.models import clip, unet, vae

    gen = torch.Generator().manual_seed(3)
    return {"unet": unet.init_unet_params(gen, unet.tiny_config(cross_attention_dim=32)),
            "vae": vae.init_vae_params(gen, vae.tiny_vae_config()),
            "text": clip.init_clip_params(gen, clip.tiny_clip_config(hidden=32))}


def _jax_solo_images(devices8, trees):
    """The JAX package's solo step runs of the three requests on a 4-device
    mesh (tests/test_stepbatch.py's ``build_sd_pipeline`` shapes)."""
    from distrifuser_tpu import DistriConfig as JaxDistriConfig
    from distrifuser_tpu.models.clip import tiny_clip_config
    from distrifuser_tpu.models.unet import tiny_config
    from distrifuser_tpu.models.vae import tiny_vae_config
    from distrifuser_tpu.pipelines import DistriSDPipeline
    from distrifuser_tpu.serve.executors import PipelineExecutor

    cfg = JaxDistriConfig(devices=devices8[:WORLD], height=128, width=128, warmup_steps=1,
                          batch_size=2)
    pipe = DistriSDPipeline.from_params(
        cfg, tiny_config(cross_attention_dim=32, sdxl=False), jax_layout(trees["unet"]),
        tiny_vae_config(), jax_layout(trees["vae"]), [tiny_clip_config(hidden=32)],
        [jax_layout(trees["text"])])
    pipe.set_stepwise(True)
    ex = PipelineExecutor(pipe, steps=STEPS)
    ex._draw_latents = lambda seeds: _seeded_latents(seeds).numpy()
    images = []
    for prompt, seed in REQUESTS:
        w = ex.step_begin(prompt, "", seed, 5.0)
        for _ in range(STEPS):
            ex.step_run([w])
        images.append(np.asarray(ex.step_finish(w)))
    return images


@pytest.fixture(scope="module")
def ranked(devices8, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("step_ranks")
    trees = _trees()
    torch.save({**trees, "steps": STEPS, "requests": REQUESTS}, tmp / "in.pt")
    wait = run_ranks(WORLD, step_ranks_worker, tmp, str(tmp / "in.pt"), str(tmp / "out"),
                     join=False)
    jax_images = _jax_solo_images(devices8, trees)
    wait()
    ranks = [torch.load(f"{tmp / 'out'}.rank{r}", weights_only=False) for r in range(WORLD)]
    return ranks, jax_images


@pytest.mark.parametrize("case", ("whole", "staged", "step_join", "step_preempt"))
def test_collective_fakes_keep_one_order_on_four_ranks(ranked, case):
    ranks, _ = ranked
    lead = ranks[0][case]
    assert lead["records"] and all(r.get("ok") for r in lead["records"]), lead["records"]
    assert lead["health"]["status"] == "ok" and lead["health"]["ranks"]["world"] == WORLD
    for other in ranks[1:]:
        assert other[case]["log"] == lead["log"] and other[case]["built"] == lead["built"]
    if case == "staged":
        assert lead["peak"] == 2
    if case == "step_preempt":
        assert {"step_park", "step_resume"} <= {op for _, op in lead["log"]}
        assert [r["preempts"] for r in lead["records"]] == [1, 0]


def test_mixed_signature_groups_over_four_ranks_give_solo_bits(ranked):
    ranks, _ = ranked
    got = ranks[0]["mixed"]
    assert got["is_sp"] and all(got["signatures"])
    assert got["sig_a_differs"] and got["sig_bc_equal"]
    # b+c share the warmup signature (one dispatch); a dispatches alone
    assert got["stats_mixed"]["dispatches"] == 2 and got["stats_mixed"]["packed_rows"] == 3
    assert got["bc_shared"]
    assert got["stats_2"]["dispatches"] == 1 and got["stats_3"]["dispatches"] == 1
    for image, ref in zip(got["images"], got["refs"]):
        assert image.shape == (32, 32, 3) and np.isfinite(image).all()
        np.testing.assert_array_equal(image, ref)


def test_mixed_signature_groups_over_four_ranks_match_jax(ranked):
    ranks, jax_images = ranked
    for image, want in zip(ranks[0]["mixed"]["images"], jax_images):
        np.testing.assert_allclose(image, want, rtol=0, atol=SDXL_TOL)


def test_parked_carry_resumes_bit_for_bit_after_a_follower_failure(ranked):
    ranks, _ = ranked
    lead = ranks[0]["step_fault"]
    slack, tight = lead["records"]
    assert slack["ok"] and slack["preempts"] == 1, slack
    assert tight["error"] == "ExecuteFailedError" and "rank 1" in tight["text"]
    health = lead["health"]
    assert health["status"] != "fatal" and health["ranks"]["aborted"] is None
    assert health["ranks"]["aborts"] == 1 and health["ranks"]["rebuilds"] == 1
    assert {"step_park", "step_resume"} <= {op for _, op in lead["log"]}
    for other in ranks:
        before, after = other["step_fault"]["generations"]
        assert after == before + 1
        assert other["step_fault"]["log"] == lead["log"]
        assert other["step_fault"]["built"] == lead["built"]
