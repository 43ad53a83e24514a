"""PyTorch port: serving over n ranks (serve/ranks.py) at 2 gloo ranks.

One spawn of two ranks runs every case (tests/test_torch_port_ranks.py
``serve_ranks_worker``), each under a time limit of its own, so a deadlock
fails the test instead of hanging it:

* the collective fakes (serve/testing.py ``CollectiveFakeExecutor``), whose
  every operation all-reduces its command's sequence number and op code
  over a gloo group and fails unless both ranks run the same command:
  whole-batch, staged with two batches in flight (a decode beside the next
  denoise), step rounds with a join and with a preemption (a park and a
  resume); evictions and the works of staged batches that failed on rank 0
  (after a denoise, and after an encode that rank 0 never got) released on
  the follower; a failure on rank 1 only before the go (retryable: one
  retry; OOM-like: the ladder's weight_quant_on rung rebuilds on both ranks;
  a hang past rank 0's watchdog: abandoned, the next request served after
  the rebuild); a failure on rank 1 alone inside an operation, between the
  fake's two group operations (an error, an out-of-memory, a hang past the
  watchdog bound): the data groups aborted and made anew on both ranks, the
  ladder acting as on one card, the request and the next one served (queue
  3 fault 9);
* the tiny SDXL pipeline at sp 2 with the CFG folded, warmup 1, 3 DDIM
  steps: served whole-batch and staged, every image equal bit for bit to
  the pipeline's solo call at world 2 on the same latents, and within
  ``SDXL_TOL`` of the JAX package's server over a 2-device fake mesh on the
  same weights and latents (computed here while the ranks run); a call
  that fails on rank 1 alone between two of its collectives, served after
  the data groups' rebuild at the solo call's bits (fault 9); a step
  server over the ranks stops itself at step 1 and exports its carry, a
  second one imports it and finishes at the solo call's bits, and a server
  on one rank refuses the snapshot, typed, naming the layout.
"""

import numpy as np
import pytest
import torch

from distrifuser_tpu_torch.models.weights import params_from_jax
from test_torch_port_ranks import _seeded_latents, run_ranks, serve_ranks_worker
from test_torch_port_serve_pipeline import SDXL_TOL, sdxl_trees  # noqa: F401 -- fixture

WORLD, STEPS = 2, 3
REQUESTS = [("a lighthouse at dusk", 11), ("a corgi on a skateboard", 12),
            ("a watercolor skyline", 13)]


def _jax_served(devices8, trees):
    """The JAX package's server over a 2-device mesh (sp 2, the CFG
    folded), the same requests, latents and weights."""
    from distrifuser_tpu import DistriConfig as JaxDistriConfig
    from distrifuser_tpu import pipelines as jax_pipelines
    from distrifuser_tpu.models import clip as jax_clip
    from distrifuser_tpu.models import unet as jax_unet
    from distrifuser_tpu.models import vae as jax_vae
    from distrifuser_tpu.serve import InferenceServer, ServeConfig, pipeline_executor_factory
    from test_torch_port_pipeline import _text_configs

    unet, vae, text = trees

    def build(key):
        cfg = JaxDistriConfig(devices=devices8[:WORLD], height=128, width=128,
                              warmup_steps=1, batch_size=2, split_batch=False,
                              use_cuda_graph=False)
        return jax_pipelines.DistriSDXLPipeline.from_params(
            cfg, jax_unet.tiny_config(cross_attention_dim=32, sdxl=True), unet,
            jax_vae.tiny_vae_config(), vae, _text_configs(jax_clip), text)

    inner = pipeline_executor_factory(build)

    def factory(key):
        ex = inner(key)
        ex._draw_latents = lambda seeds: _seeded_latents(seeds).numpy()
        return ex

    config = ServeConfig(buckets=((128, 128),), max_batch_size=2, batch_window_s=0.3,
                         default_steps=STEPS, warmup_buckets=((128, 128),))
    with InferenceServer(factory, config, model_id="tiny-sdxl",
                         mesh_plan=f"dp1.cfg1.sp{WORLD}") as server:
        futs = [server.submit(p, height=128, width=128, seed=s) for p, s in REQUESTS]
        return [np.asarray(f.result(timeout=300).output) for f in futs]


@pytest.fixture(scope="module")
def served(devices8, sdxl_trees, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("serve_ranks")
    unet, vae, text = sdxl_trees
    torch.save({"unet": params_from_jax(unet), "vae": params_from_jax(vae),
                "text": [params_from_jax(t) for t in text], "steps": STEPS,
                "requests": REQUESTS}, tmp / "in.pt")
    wait = run_ranks(WORLD, serve_ranks_worker, tmp, str(tmp / "in.pt"), str(tmp / "out"),
                     join=False)
    jax_images = _jax_served(devices8, sdxl_trees)
    wait()
    ranks = [torch.load(f"{tmp / 'out'}.rank{r}", weights_only=False) for r in range(WORLD)]
    return ranks, jax_images


FAKE_CASES = ("whole", "staged", "step_join", "step_preempt")


@pytest.mark.parametrize("case", FAKE_CASES)
def test_collective_fakes_keep_one_order_on_every_rank(served, case):
    ranks, _ = served
    lead = ranks[0][case]
    assert lead["records"] and all(r.get("ok") for r in lead["records"]), lead["records"]
    assert lead["health"]["status"] == "ok" and lead["health"]["ranks"]["aborted"] is None
    # every rank ran the same commands: the fakes' all-reduces agreed on each
    for other in ranks[1:]:
        assert other[case]["log"] == lead["log"]
        assert other[case]["built"] == lead["built"]
    ops = {op for _, op in lead["log"]}
    if case == "whole":
        assert ops == {"call"} and sorted(r["batch_size"] for r in lead["records"]) \
            in ([1, 2, 2], [1, 1, 1], [2, 2, 1])
    elif case == "staged":
        assert ops == {"encode", "denoise", "decode"}
        assert lead["peak"] == 2  # two batches resident at once
        assert lead["metrics"]["staging"]["completed"] == 5
    elif case == "step_join":
        assert {"step_begin", "step_run", "step_finish"} <= ops
        assert lead["metrics"]["step_batching"]["joins"] == 2
    else:
        assert {"step_park", "step_resume"} <= ops
        assert [r["preempts"] for r in lead["records"]] == [1, 0]


def test_evictions_and_dropped_works_reach_the_followers(served):
    ranks, _ = served
    lead, follower = ranks[0]["evict_drop"], ranks[1]["evict_drop"]
    # three builds in a cache of one: two evictions, each dropped on rank 1;
    # a denoise that fails on rank 0 after its go aborts the data groups,
    # and their rebuild drops the executor on both ranks once more
    assert lead["evictions"] == [2, 1, 0] and follower["evicted"] == 3
    # the staged batches that failed on rank 0 after rank 1 denoised one
    # and encoded the other
    assert lead["records"] == [True, True, True, "ExecuteFailedError", True,
                               "ExecuteFailedError", True]
    assert follower["dropped"] == 2


def test_follower_execute_error_is_retried(served):
    ranks, _ = served
    lead = ranks[0]["follower_execute_error"]
    (rec,) = lead["records"]
    assert rec["ok"] and rec["retries"] == 1
    assert lead["health"]["requests"]["retries"] == 1
    assert "rank 1" in lead["health"]["last_errors"][-1]["message"]


def test_follower_oom_walks_the_ladder_on_every_rank(served):
    ranks, _ = served
    lead = ranks[0]["follower_oom"]
    (rec,) = lead["records"]
    assert rec["ok"] and rec["degradations"] == ["weight_quant_on"]
    assert rec["exec_key"].endswith(":wq-int8")
    assert lead["metrics"]["requests"]["degraded_weight_quant_on"] == 1
    assert lead["health"]["status"] == "degraded"
    # the rebuild ran on both ranks
    for other in ranks:
        assert other["follower_oom"]["built"] == lead["built"]
        assert [k.endswith(":wq-int8") for k in lead["built"]] == [False, True]


def test_follower_hang_is_abandoned_and_the_server_recovers(served):
    """A hang on rank 1 before the go, past rank 0's watchdog: the watchdog
    abandons the command and aborts the data groups, rank 1's dispatcher
    abandons its lane (it reports for it), and the next request is served
    after the rebuild -- the server never stops (it was fatal before)."""
    ranks, _ = served
    lead = ranks[0]["follower_hang"]
    first, second = lead["records"]
    assert first["error"] == "WatchdogTimeoutError"
    assert second["ok"] and second["retries"] == 0
    assert lead["health"]["status"] != "fatal" and lead["health_after"]["status"] != "fatal"
    assert lead["health"]["ranks"]["aborts"] == 1 and lead["health"]["ranks"]["rebuilds"] == 1
    assert lead["health"]["ranks"]["aborted"] is None
    assert lead["metrics"]["requests"]["watchdog_timeouts"] == 1
    for other in ranks:
        before, after = other["follower_hang"]["generations"]
        assert after == before + 1
        # the abandoned command ran nowhere; the next one everywhere
        assert other["follower_hang"]["log"] == lead["log"]
        assert [op for _, op in other["follower_hang"]["log"]] == ["call"]
        assert other["follower_hang"]["built"] == lead["built"]


@pytest.mark.parametrize("case", ("inop_error", "inop_oom", "inop_hang"))
def test_follower_failure_inside_an_operation_rebuilds_the_groups(served, case):
    """Queue 3 fault 9: rank 1 alone fails (an error, an out-of-memory) or
    hangs past the watchdog bound between the two group operations of a
    whole-batch call, while rank 0 waits in the second.  The server stays
    up: the data groups are aborted and made anew on both ranks (one more
    generation), every executor is rebuilt, the error walks the ladder as
    on one card (the OOM to weight_quant_on on both ranks, the others one
    retry), and the request and the next one are served with their solo
    images."""
    ranks, _ = served
    lead = ranks[0][case]
    assert len(lead["records"]) == 2
    assert all(r.get("ok") for r in lead["records"]), lead["records"]
    health = lead["health"]
    assert health["status"] != "fatal" and health["scheduler_alive"]
    assert health["ranks"]["aborts"] == 1 and health["ranks"]["rebuilds"] == 1
    assert health["ranks"]["aborted"] is None
    first = lead["records"][0]
    assert first["retries"] == 1
    if case == "inop_oom":
        assert first["degradations"] == ["weight_quant_on"]
        assert [k.endswith(":wq-int8") for k in lead["built"]] == [False, True]
    else:
        assert first["degradations"] == [] and len(set(lead["built"])) == 1
        assert len(lead["built"]) == 2  # built again after the rebuild
    for other in ranks:
        before, after = other[case]["generations"]
        assert after == before + 1
        assert other[case]["built"] == lead["built"]
        assert other[case]["log"] == lead["log"]


@pytest.mark.parametrize("case", ("sdxl_whole", "sdxl_staged"))
def test_tiny_sdxl_served_equals_solo_and_jax(served, case):
    ranks, jax_images = served
    lead = ranks[0]
    got = lead[case]["images"]
    assert len(got) == len(REQUESTS) and max(lead[case]["batch_sizes"]) == 2
    if case == "sdxl_staged":
        assert lead[case]["staging"]["completed"] >= 2
    for image, solo, want in zip(got, lead["solo"]["fused"], jax_images):
        assert image.shape == (32, 32, 3) and np.isfinite(image).all()
        np.testing.assert_array_equal(image, solo)
        np.testing.assert_allclose(image, want, rtol=0, atol=SDXL_TOL)


def test_tiny_sdxl_failure_inside_a_call_recovers_with_solo_bits(served):
    """Queue 3 fault 9 on the real pipeline: rank 1 alone raises in the
    middle of a denoise, between two all-gathers, while rank 0 runs on into
    the next collective.  The data groups are aborted and made anew on both
    ranks, the retry builds the pipeline anew, and both requests' images
    equal the solo call at the rebuilt key bit for bit, and the JAX
    package's server within ``SDXL_TOL``."""
    ranks, jax_images = served
    lead = ranks[0]
    rec = lead["sdxl_inop"]
    assert rec["retries"] == [1, 0]
    health = rec["health"]
    assert health["status"] != "fatal" and health["ranks"]["aborted"] is None
    assert health["ranks"]["aborts"] == 1 and health["ranks"]["rebuilds"] == 1
    for other in ranks:
        before, after = other["sdxl_inop"]["generations"]
        assert after == before + 1
    for image, solo, want in zip(rec["images"], lead["solo"]["fused"], jax_images):
        assert image.shape == (32, 32, 3) and np.isfinite(image).all()
        np.testing.assert_array_equal(image, solo)
        np.testing.assert_allclose(image, want, rtol=0, atol=SDXL_TOL)


def test_tiny_sdxl_carry_migrates_between_servers_over_ranks(served):
    ranks, jax_images = served
    lead = ranks[0]
    assert lead["exported_at"] == 1
    meta = lead["snapshot_meta"]
    assert meta["step"] == 1 and meta["exec_key"]["mesh_plan"] == "dp1.cfg1.sp2"
    counts = meta["rank_leaves"]
    assert len(counts) == WORLD and counts[0] == counts[1] > 0
    mig = lead["migrated"]
    assert mig["migrations"] == 1 and mig["steps_salvaged"] == 1
    np.testing.assert_array_equal(mig["image"], lead["solo"]["step"][0])
    np.testing.assert_allclose(mig["image"], jax_images[0], rtol=0, atol=SDXL_TOL)


@pytest.mark.parametrize("tier", ("full", "step_cache", "comm_compress",
                                  "partial_refresh", "reduced_steps"))
def test_controller_tier_keys_build_and_serve_over_ranks(served, tier):
    """Each tier of the SLO controller's table builds over the two ranks and
    serves its solo call's image; the wire tiers put compressed (and
    partial) refreshes on the wire, so their images leave full's."""
    ranks, _ = served
    got = ranks[0]["tiers"]
    rec = got[tier]
    assert np.isfinite(rec["image"]).all()
    np.testing.assert_array_equal(rec["image"], rec["solo"])
    if tier in ("comm_compress", "partial_refresh"):
        plan = rec["comm_plan"]
        assert plan["comm_compress"] == "int8"
        assert plan["refresh_fraction"] == (0.5 if tier == "partial_refresh" else 1.0)
        assert np.abs(rec["image"] - got["step_cache"]["image"]).max() > 0
        assert plan["bytes_per_step"]["stale"] < got["full"]["comm_plan"]["bytes_per_step"][
            "stale"]
    if tier != "full":
        assert np.abs(rec["image"] - got["full"]["image"]).max() > 0


def test_carry_of_two_ranks_is_refused_by_a_one_rank_server(served):
    ranks, _ = served
    name, text = ranks[0]["one_rank"]
    assert name == "MigrationRejectedError"
    assert "mesh_plan" in text and "dp1.cfg1.sp2" in text and "dp1.cfg1.sp1" in text


def test_fleet_refuses_a_replica_over_ranks():
    """A fleet's replica spans one rank until step 16h: a ``mesh_plan`` of
    more, or an executor over more, is refused naming the step."""
    from distrifuser_tpu_torch.serve import Replica, ServeConfig
    from distrifuser_tpu_torch.serve.replica import refuse_ranked_replica
    from distrifuser_tpu_torch.serve.testing import FakeExecutorFactory

    with pytest.raises(ValueError, match="span 4 .dp1.cfg2.sp2.*ROADMAP item 16, step 16h"):
        Replica("r0", FakeExecutorFactory(), ServeConfig(), mesh_plan="dp1.cfg2.sp2")
    with pytest.raises(ValueError, match="span 2 .*step 16h"):
        refuse_ranked_replica(world_size=2)
    refuse_ranked_replica("dp1.cfg1.sp1", world_size=1)  # one rank: accepted
