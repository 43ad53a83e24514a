"""PyTorch port: step-level continuous batching (ROADMAP item 16c) against
the JAX package's.

* The scenarios of tests/test_stepbatch.py that need no compiled model run
  once per package on the weightless step fakes (serve/testing.py), with
  the same configs and requests: both pass the JAX test's assertions and
  their records (images, counters, slot-pool snapshots, previews, the
  typed errors) are equal -- config and key validation, the slot-pool
  policy (EDF slack, cohort width, victim choice, park accounting), the
  queue's EDF peeks, the server's rounds, bit-identity of solo, joined and
  whole-batch runs, previews and time to first preview, preemption,
  cancellation, queued deadlines, stop, a failed and a watchdog-abandoned
  step, the slo_snapshot step block, pack alignment and the packed-dispatch
  counters.
* ``parallel/rowpack.py``: ``axes_from_shapes``, ``pack_rows`` and
  ``extract_row`` equal the JAX functions on numpy-made trees exactly,
  ambiguity refusals included.
* The tiny real pipelines (SDXL, PixArt-α, SD3) through the port's step
  contract: joined, parked, packed (``step_pack_stats``: one dispatch
  carrying 2 rows) and migrated requests equal their solo step runs and
  the monolithic call bit for bit; the port's step run equals the JAX
  package's within the family's tolerance.
* The transformer runners' ``stepwise_carry_*`` at 2 gloo ranks (sp 2):
  two carries stepped interleaved give the latents of the same carries
  stepped one after the other and of ``generate`` bit for bit, and the JAX
  runner's stepwise carries on the fake mesh of 2 within 5e-4.
"""

import dataclasses
import importlib
import threading
import time

import numpy as np
import pytest
import torch

PACKAGES = ("distrifuser_tpu", "distrifuser_tpu_torch")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's tiny models (restored after):
    the whole suite runs six workers on the machine's cores, and the
    default of one thread a core oversubscribes them."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class Pkg:
    def __init__(self, name):
        self.name = name
        self.serve = importlib.import_module(f"{name}.serve")
        self.testing = importlib.import_module(f"{name}.serve.testing")
        self.queue = importlib.import_module(f"{name}.serve.queue")
        self.stepbatch = importlib.import_module(f"{name}.serve.stepbatch")
        self.resilience = importlib.import_module(f"{name}.serve.resilience")
        self.config = importlib.import_module(f"{name}.utils.config")


def key_for(P, model="m", h=64, w=64, steps=4, exec_mode="step", **kw):
    return P.serve.ExecKey(model_id=model, scheduler="ddim", height=h, width=w,
                           steps=steps, cfg=True, mesh_plan="dp1.cfg1.sp1",
                           exec_mode=exec_mode, **kw)


def step_config(P, **kw):
    kw.setdefault("enabled", True)
    kw.setdefault("slots", 4)
    return P.serve.StepBatchConfig(**kw)


def serve_config(P, **kw):
    kw.setdefault("max_queue_depth", 32)
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("batch_window_s", 0.001)
    kw.setdefault("buckets", ((64, 64),))
    kw.setdefault("warmup_buckets", ())
    kw.setdefault("default_steps", 4)
    kw.setdefault("default_ttl_s", 60.0)
    kw.setdefault("step_batching", step_config(P))
    return P.serve.ServeConfig(**kw)


def mk_request(P, prompt="p", steps=4, ttl=60.0, seed=0, now=None):
    now = time.monotonic() if now is None else now
    return P.queue.Request(prompt=prompt, height=64, width=64, num_inference_steps=steps,
                           deadline=now + ttl, seed=seed, enqueue_ts=now)


def mk_state(P, req, steps_total=None, **kw):
    k = key_for(P, steps=steps_total or req.num_inference_steps)
    kw.setdefault("base_key", k)
    kw.setdefault("ekey", k)
    kw.setdefault("executor", object())
    kw.setdefault("compile_hit", True)
    return P.stepbatch.SlotState(request=req, work={}, steps_total=k.steps, **kw)


def wait_occupied(server):
    deadline = time.monotonic() + 10
    while not server.stepbatch.occupied():
        assert time.monotonic() < deadline, "never admitted"
        time.sleep(0.002)


# -- the scenarios: each asserts the JAX test's claims and returns a record --


def config_validates(P):
    for kw, match in (({"slots": 0}, "slots"), ({"preview_interval": -1}, "preview_interval"),
                      ({"step_service_prior_s": 0.0}, "step_service_prior_s"),
                      ({"step_width": -1}, "step_width")):
        with pytest.raises(ValueError, match=match):
            P.serve.StepBatchConfig(**kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        serve_config(P, pipeline_stages=True)
    with pytest.raises(ValueError, match="patch-parallel"):
        serve_config(P, parallelism="pipefusion", pipe_patches=2)
    k = key_for(P)
    assert ":step" in k.short()
    assert key_for(P, exec_mode="stepwise").short() != k.short()
    with pytest.raises(ValueError, match="pipefusion"):
        key_for(P, exec_mode="step", parallelism="pipefusion", pipe_patches=2)
    with pytest.raises(ValueError, match="exec_mode"):
        key_for(P, exec_mode="warp")
    return k.short()


def stepwise_rung_never_applies_to_step_keys(P):
    ladder = P.resilience.DegradationLadder(P.config.ResilienceConfig(), buckets=((64, 64),))
    assert ladder._applicable(P.resilience.RUNG_STEPWISE, key_for(P, exec_mode="fused"))
    assert not ladder._applicable(P.resilience.RUNG_STEPWISE, key_for(P, exec_mode="step"))
    return True


def server_keys_buckets_at_step_mode(P):
    server = P.serve.InferenceServer(P.testing.StepFakeExecutorFactory(), serve_config(P))
    assert server._exec_key_for(64, 64, 4, cfg=True).exec_mode == "step"
    mono = P.serve.InferenceServer(P.testing.FakeExecutorFactory(),
                                   serve_config(P, step_batching=P.serve.StepBatchConfig()))
    assert mono._exec_key_for(64, 64, 4, cfg=True).exec_mode == "fused"
    return server._exec_key_for(64, 64, 4, cfg=True).short()


def slack_cohort_width_victim_park(P):
    SB = P.stepbatch.StepBatcher
    sb = SB(step_config(P, slots=3, step_service_prior_s=0.1), clock=lambda: 100.0)
    tight = mk_state(P, mk_request(P, "tight", ttl=0.5, now=100.0))
    loose = mk_state(P, mk_request(P, "loose", ttl=5.0, now=100.0))
    sb.admit(loose)
    sb.admit(tight)
    assert sb.state_slack(tight, 100.0) == pytest.approx(0.1)
    assert sb.state_slack(loose, 100.0) == pytest.approx(4.6)
    order = [s.request.prompt for s in sb.cohort(100.0)]
    assert order == ["tight", "loose"]
    sb = SB(step_config(P, slots=4, step_width=2, step_service_prior_s=0.1), clock=lambda: 0.0)
    for i, ttl in enumerate((5.0, 1.0, 3.0, 0.7)):
        sb.admit(mk_state(P, mk_request(P, f"r{i}", ttl=ttl, now=0.0)))
    width = [s.request.prompt for s in sb.cohort(0.0)]
    assert width == ["r3", "r1"]
    sb = SB(step_config(P, slots=2, step_service_prior_s=0.1, preempt_margin_s=0.5),
            clock=lambda: 0.0)
    tight = mk_state(P, mk_request(P, "tight", ttl=0.6, now=0.0))
    loose = mk_state(P, mk_request(P, "loose", ttl=9.0, now=0.0))
    sb.admit(tight)
    sb.admit(loose)
    assert sb.pick_victim(newcomer_slack=1.0, now=0.0) is loose
    assert sb.pick_victim(newcomer_slack=8.5, now=0.0) is None
    loose.preempts = 1
    assert sb.pick_victim(newcomer_slack=1.0, now=0.0) is None
    sb2 = SB(step_config(P, slots=1, allow_preemption=False), clock=lambda: 0.0)
    sb2.admit(mk_state(P, mk_request(P, "loose2", ttl=9.0, now=0.0)))
    assert sb2.pick_victim(newcomer_slack=0.0, now=0.0) is None
    sb = SB(step_config(P, slots=2), clock=lambda: 0.0)
    a, b = mk_state(P, mk_request(P, "a", now=0.0)), mk_state(P, mk_request(P, "b", now=0.0))
    sb.admit(a), sb.admit(b)
    sb.park(a)
    assert sb.free_slots() == 1 and a.parked and a.preempts == 1
    assert sb.remaining_steps_total() == 8
    sb.unpark(a)
    sb.remove(a), sb.remove(b)
    snap = sb.snapshot()
    est = [None]
    sb3 = SB(step_config(P, step_service_prior_s=0.25), clock=lambda: 0.0,
             step_estimate=lambda: est[0])
    assert sb3.per_step_s() == 0.25
    sb3.note_round(0.1)
    assert sb3.per_step_s() == pytest.approx(0.1)
    est[0] = 0.05
    assert sb3.per_step_s() == 0.05
    return order, width, snap, sb3.snapshot()["round_s_mean"]


def queue_peek_best_and_remove(P):
    q = P.queue.RequestQueue(8)
    now = time.monotonic()
    reqs = [mk_request(P, f"r{i}", ttl=ttl, now=now) for i, ttl in enumerate((5.0, 1.0, 3.0))]
    for r in reqs:
        q.put(r)
    assert q.peek_best(lambda r: r.deadline) is reqs[1]
    assert q.peek_urgent(lambda r: r.deadline) is reqs[1]
    assert len(q) == 3
    assert q.remove(reqs[1]) and not q.remove(reqs[1])
    assert q.peek_best(lambda r: r.deadline) is reqs[2]
    assert q.remove(reqs[2]) and q.remove(reqs[0])
    assert q.peek_best(lambda r: r.deadline) is None
    return len(q)


def continuous_server_completes(P):
    fac = P.testing.StepFakeExecutorFactory(batch_size=4, step_time_s=0.002)
    with P.serve.InferenceServer(fac, serve_config(P)) as server:
        futs = [server.submit(f"p{i}", height=64, width=64, seed=i) for i in range(6)]
        results = [f.result(timeout=30) for f in futs]
    key = fac.built[0]
    assert key.exec_mode == "step"
    for i, r in enumerate(results):
        assert r.batch_size == 1 and ":step" in r.exec_key
        assert np.array_equal(r.output, P.testing.fake_image(f"p{i}", i, key))
    snap = server.metrics_snapshot()
    assert snap["step_batching"]["joins"] == 6 and snap["step_batching"]["leaves"] == 6
    assert snap["requests"]["completed"] == 6
    assert snap["requests"]["steps_executed"] == 24
    return ([np.asarray(r.output).tobytes() for r in results], sorted(snap),
            sorted(snap["step_batching"]), snap["requests"]["steps_executed"])


def bit_identity_solo_vs_joined(P):
    def run(model, submissions, stagger_s=0.0, continuous=True):
        cfg = (serve_config(P) if continuous
               else serve_config(P, step_batching=P.serve.StepBatchConfig()))
        fac = (P.testing.StepFakeExecutorFactory(batch_size=4, step_time_s=0.003)
               if continuous else P.testing.FakeExecutorFactory(batch_size=4,
                                                                step_time_s=0.003))
        with P.serve.InferenceServer(fac, cfg, model_id=model) as server:
            futs = []
            for prompt, seed in submissions:
                futs.append(server.submit(prompt, height=64, width=64, seed=seed))
                if stagger_s:
                    time.sleep(stagger_s)
            return [f.result(timeout=30).output for f in futs]

    out = []
    for model in ("unet", "dit", "mmdit"):
        solo = run(model, [("a cat", 7)])
        joined = run(model, [("a cat", 7), ("a dog", 9), ("a fox", 11)], stagger_s=0.004)
        whole = run(model, [("a cat", 7)], continuous=False)
        np.testing.assert_array_equal(solo[0], joined[0])
        np.testing.assert_array_equal(solo[0], whole[0])
        k = key_for(P, model=model, steps=4)
        np.testing.assert_array_equal(joined[1], P.testing.fake_image("a dog", 9, k))
        np.testing.assert_array_equal(joined[2], P.testing.fake_image("a fox", 11, k))
        out.append([np.asarray(x).tobytes() for x in joined])
    return out


def previews_and_ttfp(P):
    fac = P.testing.StepFakeExecutorFactory(batch_size=4, step_time_s=0.002)
    cfg = serve_config(P, step_batching=step_config(P, preview_interval=2), default_steps=6)
    seen = []
    with P.serve.InferenceServer(fac, cfg) as server:
        f_on = server.submit("p", height=64, width=64, seed=1, num_inference_steps=6,
                             on_progress=lambda s, t, img: seen.append((s, t, img.copy())))
        f_off = server.submit("q", height=64, width=64, seed=2, num_inference_steps=6)
        r_on, r_off = f_on.result(timeout=30), f_off.result(timeout=30)
    assert [s for s, _, _ in seen] == [2, 4, 6] and all(t == 6 for _, t, _ in seen)
    np.testing.assert_array_equal(seen[0][2], P.testing.fake_preview("p", 1, fac.built[0], 2))
    assert r_on.previews == 3 and r_on.first_preview_s > 0
    assert r_off.previews == 0 and r_off.first_preview_s is None
    snap = server.metrics_snapshot()
    assert snap["requests"]["step_previews"] == 3
    fp = [w for lbls, w in server.registry.family("serve_latency_seconds")
          if lbls.get("phase") == "first_preview"]
    assert fp and fp[0].snapshot()["count"] == 1
    return [(s, t, img.tobytes()) for s, t, img in seen], snap["requests"]["step_previews"]


def preemption_parks_and_resumes(P):
    # tests/test_stepbatch.py's case at 10x its time constants (50 ms
    # steps, the tight request 2.25 s to live, 45 steps' worth), so that a
    # loaded machine keeps the preemption window: the newcomer must see
    # 30 x the per-step estimate fit in its deadline and 30 + ~29 not fit,
    # which holds for estimates of 38 to 75 ms
    fac = P.testing.StepFakeExecutorFactory(batch_size=4, step_time_s=0.05)
    cfg = serve_config(P, default_steps=30,
                       step_batching=step_config(P, slots=1, step_service_prior_s=0.05))
    with P.serve.InferenceServer(fac, cfg) as server:
        fa = server.submit("slack", height=64, width=64, seed=1, ttl_s=60.0)
        wait_occupied(server)
        time.sleep(0.02)
        fb = server.submit("tight", height=64, width=64, seed=2, ttl_s=2.25)
        ra, rb = fa.result(timeout=30), fb.result(timeout=30)
    key = fac.built[0]
    assert ra.preempts == 1 and rb.preempts == 0
    ex = fac.executors[0]
    assert ex.park_calls == 1 and ex.resume_calls == 1
    snap = server.metrics_snapshot()["step_batching"]
    assert snap["preempts"] == 1 and snap["resumes"] == 1
    np.testing.assert_array_equal(ra.output, P.testing.fake_image("slack", 1, key))
    np.testing.assert_array_equal(rb.output, P.testing.fake_image("tight", 2, key))
    return ra.preempts, rb.preempts, snap["preempts"], snap["resumes"]


def cancelled_future_frees_slot(P):
    fac = P.testing.StepFakeExecutorFactory(batch_size=4, step_time_s=0.005)
    cfg = serve_config(P, default_steps=40,
                       step_batching=step_config(P, slots=1, allow_preemption=False))
    with P.serve.InferenceServer(fac, cfg) as server:
        fa = server.submit("long", height=64, width=64, seed=1)
        wait_occupied(server)
        fb = server.submit("next", height=64, width=64, seed=2)
        fa.cancel()
        rb = fb.result(timeout=30)
    assert np.array_equal(rb.output, P.testing.fake_image("next", 2, fac.built[0]))
    assert server.metrics_snapshot()["requests"].get("step_cancelled", 0) == 1
    return np.asarray(rb.output).tobytes()


def queued_deadline_rejected(P):
    fac = P.testing.StepFakeExecutorFactory(batch_size=4, step_time_s=0.01)
    cfg = serve_config(P, default_steps=20, step_batching=step_config(P, slots=1))
    with P.serve.InferenceServer(fac, cfg) as server:
        server.submit("hog", height=64, width=64, seed=1)
        wait_occupied(server)
        doomed = server.submit("doomed", height=64, width=64, seed=2, ttl_s=0.01)
        with pytest.raises(P.serve.DeadlineExceededError):
            doomed.result(timeout=30)
    assert server.metrics_snapshot()["requests"]["rejected_deadline"] == 1
    return True


def stop_resolves_every_future(P):
    fac = P.testing.StepFakeExecutorFactory(batch_size=4, step_time_s=0.01)
    cfg = serve_config(P, default_steps=200, step_batching=step_config(P, slots=2))
    server = P.serve.InferenceServer(fac, cfg).start(warmup=False)
    futs = [server.submit(f"p{i}", height=64, width=64, seed=i) for i in range(5)]
    wait_occupied(server)
    server.stop(timeout=30.0)
    kinds = []
    for f in futs:
        with pytest.raises(P.serve.ServerClosedError) as info:
            f.result(timeout=5)
        kinds.append(type(info.value).__name__)
    assert not server.stepbatch.occupied() and not server.stepbatch.parked
    return sorted(kinds)


def step_failure_terminal(P):
    class BoomStepFactory(P.testing.StepFakeExecutorFactory):
        def _new_executor(self, key):
            ex = super()._new_executor(key)
            orig = ex.step_run

            def boom(works, _orig=orig, _ex=ex):
                if len(_ex.step_calls) >= 2:
                    raise RuntimeError("injected step failure")
                return _orig(works)

            ex.step_run = boom
            return ex

    fac = BoomStepFactory(batch_size=4, step_time_s=0.001)
    with P.serve.InferenceServer(fac, serve_config(P)) as server:
        f = server.submit("p", height=64, width=64, seed=1)
        with pytest.raises(P.serve.ExecuteFailedError):
            f.result(timeout=30)
    snap = server.metrics_snapshot()
    assert snap["requests"]["failed_execute"] >= 1
    assert not server.stepbatch.occupied()
    return snap["requests"]["failed_execute"]


def watchdog_abandoned_step_defers_release(P):
    hang = threading.Event()
    aborted = threading.Event()

    class HangStepFactory(P.testing.StepFakeExecutorFactory):
        def _new_executor(self, key):
            ex = super()._new_executor(key)
            ex.step_run = lambda works: hang.wait(10)
            orig_abort = ex.step_abort
            ex.step_abort = lambda w: (aborted.set(), orig_abort(w))[1]
            return ex

    fac = HangStepFactory(batch_size=4)
    cfg = serve_config(P, resilience=P.config.ResilienceConfig(watchdog_timeout_s=0.05,
                                                               max_retries=0))
    with P.serve.InferenceServer(fac, cfg) as server:
        f = server.submit("p", height=64, width=64, seed=1)
        with pytest.raises(P.serve.WatchdogTimeoutError):
            f.result(timeout=30)
        ex = fac.executors[0]
        assert not aborted.wait(0.1), "buffers released under the worker"
        assert server.cache.pin_count(ex) >= 1
        hang.set()
        deadline = time.monotonic() + 10
        while not aborted.is_set() or server.cache.pin_count(ex):
            assert time.monotonic() < deadline, "deferred release never ran"
            time.sleep(0.005)
    return True


def slo_snapshot_step_block(P):
    fac = P.testing.StepFakeExecutorFactory(batch_size=4, step_time_s=0.0)
    with P.serve.InferenceServer(fac, serve_config(P)) as server:
        snap = server.slo_snapshot()
        assert snap["step"]["slots"] == 4 and snap["step"]["steps_hint"] == 4
    mono = P.serve.InferenceServer(P.testing.FakeExecutorFactory(),
                                   serve_config(P, step_batching=P.serve.StepBatchConfig()))
    assert "step" not in mono.slo_snapshot()
    return sorted(snap["step"])


def pack_align_and_counters(P):
    def states(sb, sigs_ttls, now):
        out = []
        for sig, ttl in sigs_ttls:
            st = mk_state(P, mk_request(P, ttl=ttl, now=now))
            st.work = {"sig": sig}
            sb.admit(st)
            out.append(st)
        return out

    SB = P.stepbatch.StepBatcher
    sb = SB(step_config(P, slots=6, step_width=2, pack_align=True), clock=time.monotonic,
            pack_signature=lambda s: s.work.get("sig"))
    now = time.monotonic()
    st = states(sb, [("A", 1.0), ("B", 2.0), ("A", 3.0), ("B", 4.0)], now)
    assert sb.cohort(now) == [st[0], st[2]] and sb.pack_aligned == 1
    sb2 = SB(step_config(P, slots=6, step_width=2, pack_align=False), clock=time.monotonic,
             pack_signature=lambda s: s.work.get("sig"))
    st2 = states(sb2, [("A", 1.0), ("B", 2.0), ("A", 3.0)], now)
    assert sb2.cohort(now) == [st2[0], st2[1]] and sb2.pack_aligned == 0
    fac = P.testing.StepFakeExecutorFactory(batch_size=4, step_time_s=0.002)
    with P.serve.InferenceServer(fac, serve_config(P)) as server:
        for f in [server.submit(f"p{i}", height=64, width=64, seed=i) for i in range(3)]:
            f.result(timeout=30)
        reqs = server.metrics_snapshot()["requests"]
    assert reqs["stepbatch_dispatches"] >= 1
    assert reqs["stepbatch_packed_rows"] == reqs["steps_executed"]
    return sb.pack_aligned, reqs["stepbatch_packed_rows"]


SCENARIOS = {f.__name__: f for f in (
    config_validates, stepwise_rung_never_applies_to_step_keys,
    server_keys_buckets_at_step_mode, slack_cohort_width_victim_park,
    queue_peek_best_and_remove, continuous_server_completes, bit_identity_solo_vs_joined,
    previews_and_ttfp, preemption_parks_and_resumes, cancelled_future_frees_slot,
    queued_deadline_rejected, stop_resolves_every_future, step_failure_terminal,
    watchdog_abandoned_step_defers_release, slo_snapshot_step_block,
    pack_align_and_counters)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_step_scenario_matches_jax(name):
    want = SCENARIOS[name](Pkg(PACKAGES[0]))
    got = SCENARIOS[name](Pkg(PACKAGES[1]))
    assert got == want


# -- parallel/rowpack.py against the JAX module --------------------------------


def _np_carry(seed, w):
    row = np.arange(6, dtype=np.float32) + seed
    base = np.tile(row[None], (w, 1))
    folded = np.concatenate([base, base + 100.0], axis=0)
    return {"x": base, "folded": folded, "ctr": np.asarray(float(seed), np.float32),
            "shared": np.ones((3,), np.float32), "none": None}


def _as(tree, f):
    return {k: (None if v is None else f(v)) for k, v in tree.items()}


def test_rowpack_matches_jax():
    import jax.numpy as jnp

    from distrifuser_tpu.parallel import rowpack as jr
    from distrifuser_tpu_torch.parallel import rowpack as pr

    J = lambda t: _as(t, jnp.asarray)  # noqa: E731
    T = lambda t: _as(t, torch.from_numpy)  # noqa: E731
    jaxes = jr.axes_from_shapes(J(_np_carry(0, 1)), J(_np_carry(0, 2)))
    paxes = pr.axes_from_shapes(T(_np_carry(0, 1)), T(_np_carry(0, 2)))
    assert [(a.axis, a.ndim) for a in paxes] == [(a.axis, a.ndim) for a in jaxes]
    width = 2
    a, b = _np_carry(1, width), _np_carry(2, width)
    cases = [([a, b], [0, 0]), ([a], [0])]
    for members, rows in cases:
        jp = jr.pack_rows([J(m) for m in members], rows, jaxes, width)
        pp = pr.pack_rows([T(m) for m in members], rows, paxes, width)
        for k in a:
            if a[k] is None:
                assert pp[k] is None
                continue
            np.testing.assert_array_equal(pp[k].numpy(), np.asarray(jp[k]))
            assert pp[k] is not members[0][k]
        for row in range(len(members)):
            je = jr.extract_row(jp, row, jaxes, width)
            pe = pr.extract_row(pp, row, paxes, width)
            for k in a:
                if a[k] is not None:
                    np.testing.assert_array_equal(pe[k].numpy(), np.asarray(je[k]))
                    np.testing.assert_array_equal(pe[k].numpy(), members[row][k])
    # a previously packed member contributes its own row
    jpk = jr.pack_rows([J(a), J(b)], [0, 0], jaxes, width)
    ppk = pr.pack_rows([T(a), T(b)], [0, 0], paxes, width)
    jre = jr.pack_rows([jpk, J(a)], [1, 0], jaxes, width)
    pre = pr.pack_rows([ppk, T(a)], [1, 0], paxes, width)
    for k in a:
        if a[k] is not None:
            np.testing.assert_array_equal(pre[k].numpy(), np.asarray(jre[k]))


def test_rowpack_refusals_match_jax():
    import jax.numpy as jnp

    from distrifuser_tpu.parallel import rowpack as jr
    from distrifuser_tpu_torch.parallel import rowpack as pr

    for lib, mk in ((jr, jnp.zeros), (pr, torch.zeros)):
        with pytest.raises(lib.AmbiguousPackAxisError, match="multiple"):
            lib.axes_from_shapes({"h": mk((1, 1, 4))}, {"h": mk((2, 2, 4))})
        with pytest.raises(lib.AmbiguousPackAxisError, match="rank"):
            lib.axes_from_shapes({"h": mk((1, 4))}, {"h": mk((2, 4, 1))})
        axes = lib.axes_from_shapes({"h": mk((1, 4))}, {"h": mk((2, 4))})
        with pytest.raises(lib.AmbiguousPackAxisError, match="structure"):
            lib.pack_rows([{"h": mk((2, 4))}, {"g": mk((2, 4))}], [0, 0], axes, 2)
        with pytest.raises(lib.AmbiguousPackAxisError, match="multiple of"):
            lib.extract_row({"h": mk((3, 4))}, 0, axes, 2)
    assert issubclass(pr.AmbiguousPackAxisError, ValueError)


# -- the tiny real pipelines through the step contract -------------------------


from test_torch_port_serve_pipeline import (  # noqa: E402
    SDXL_TOL, _jax_sdxl, _port_sdxl, sdxl_trees)  # noqa: F401 -- fixture
from test_torch_port_pixart import (  # noqa: E402
    _close as _pixart_close, _jax_pipe as _jax_pixart, _port_pipe as _port_pixart,
    dit, t5, trees)  # noqa: F401
import test_torch_port_sd3 as sd3_tests  # noqa: E402

STEPS = 3


from test_torch_port_sd3 import mmdits  # noqa: E402,F401 -- fixture


@pytest.fixture(scope="module")
def sd3_trees(mmdits):  # noqa: F811
    """The tiny SD3 pipeline's JAX trees (test_torch_port_sd3.py's
    ``trees``, under a name of its own here)."""
    gen = torch.Generator().manual_seed(12)
    clips = [sd3_tests.jax_layout(sd3_tests.port_clip.init_clip_params(gen, tc))
             for tc in sd3_tests._clip_configs(sd3_tests.port_clip)]
    t5p = sd3_tests.jax_tree(sd3_tests.port_t5.init_t5_params(
        gen, sd3_tests.port_t5.tiny_t5_config()))
    vae = sd3_tests.jax_layout(sd3_tests.port_vae.init_vae_params(
        gen, sd3_tests.port_vae.tiny_vae_config()))
    return mmdits["plain"][1], clips, t5p, vae


def _pipes(family, devices8, sdxl_trees, trees, sd3_trees, scheduler):  # noqa: F811
    if family == "sdxl":
        port, jax_ = _port_sdxl(sdxl_trees), _jax_sdxl(devices8, sdxl_trees)
        return port, jax_, lambda g, w: np.testing.assert_allclose(g, w, rtol=0,
                                                                   atol=SDXL_TOL)
    if family == "pixart":
        return (_port_pixart(trees, scheduler),
                _jax_pixart(devices8, trees, scheduler, use_cuda_graph=False),
                _pixart_close)
    return (sd3_tests._port_pipe(sd3_trees), sd3_tests._jax_pipe(devices8, sd3_trees),
            sd3_tests._close)


def _solo(ex, prompt, seed, steps):
    w = ex.step_begin(prompt, "", seed, 5.0)
    for _ in range(steps):
        ex.step_run([w])
        assert ex.step_pack_stats["dispatches"] == 1
    return np.asarray(ex.step_finish(w))


def _drive(ex, steps):
    """The canonical interleavings of the step contract: joined, packed,
    parked mid-pack, re-packed at different step indices and migrated,
    each image equal to its solo step run and to the monolithic call."""
    from distrifuser_tpu_torch.serve import migration

    ref_cat, ref_dog = _solo(ex, "a cat", 7, steps), _solo(ex, "a dog", 9, steps)
    np.testing.assert_array_equal(ref_cat, np.asarray(ex(["a cat"], [""], 5.0, [7])[0]))
    packs = 0
    # join mid-flight, pack when the signatures agree, park a packed member,
    # let the other run ahead, resume and re-pack at different indices
    wa = ex.step_begin("a cat", "", 7, 5.0)
    ex.step_run([wa])
    wb = ex.step_begin("a dog", "", 9, 5.0)
    for _ in range(2):
        same = ex.step_signature(wa) == ex.step_signature(wb)
        ex.step_run([wa, wb])
        if same:
            assert ex.step_pack_stats == {"dispatches": 1, "packed_rows": 2,
                                          "rows_capacity": 2}
            assert wa["carry"] is wb["carry"]
            packs += 1
        if wa["i"] >= steps:
            break
    ex.step_park(wa)
    assert wa.get("pack") is None
    if not ex.step_done(wb):
        ex.step_run([wb])
    ex.step_resume(wa)
    while not (ex.step_done(wa) and ex.step_done(wb)):
        live = [w for w in (wa, wb) if not ex.step_done(w)]
        if len(live) == 2 and ex.step_signature(wa) == ex.step_signature(wb):
            packs += 1
        ex.step_run(live)
    np.testing.assert_array_equal(ref_cat, np.asarray(ex.step_finish(wa)))
    np.testing.assert_array_equal(ref_dog, np.asarray(ex.step_finish(wb)))
    # a carry exported from a packed round, imported into a fresh executor
    we, wf = ex.step_begin("a cat", "", 7, 5.0), ex.step_begin("a dog", "", 9, 5.0)
    ex.step_run([we, wf])
    ex.step_run([we, wf])
    assert ex.step_pack_stats["packed_rows"] == 2
    extra, leaves = ex.step_export(wf)
    assert extra["step"] == 2 and wf.get("pack") is None
    ex.step_abort(wf)
    key = ex.key
    data = migration.encode_snapshot(
        ekey=key, family=extra.pop("family"), step=extra.pop("step"), steps_total=steps,
        request_id="1", prompt="a dog", seed=9, leaves=leaves, extra=extra)
    snap = migration.decode_snapshot(data)
    ex2 = type(ex)(ex.pipeline, steps, key=key)
    wf2 = ex2.step_import(snap.meta, list(snap.leaves), "a dog", "", 9, 5.0)
    while not ex2.step_done(wf2):
        ex2.step_run([wf2])
    np.testing.assert_array_equal(ref_dog, np.asarray(ex2.step_finish(wf2)))
    ex.step_run([we])
    np.testing.assert_array_equal(ref_cat, np.asarray(ex.step_finish(we)))
    # a preview is cheap host work of bounded size
    wd = ex.step_begin("a cat", "", 7, 5.0)
    ex.step_run([wd])
    pv = ex.step_preview(wd, 8)
    assert pv.shape[0] <= 8 and pv.shape[1] <= 8 and pv.shape[2] == 3
    assert pv.dtype == np.float32
    ex.step_abort(wd)
    return packs


@pytest.mark.parametrize("family,scheduler", [("sdxl", "ddim"), ("pixart", "dpm-solver"),
                                              ("sd3", "flow-euler")])
def test_real_step_contract_bit_identity_and_jax(devices8, family, scheduler, sdxl_trees,
                                                 trees, sd3_trees):  # noqa: F811
    from distrifuser_tpu.serve.executors import PipelineExecutor as JaxExecutor
    from distrifuser_tpu_torch.serve import ExecKey, PipelineExecutor

    port, jpipe, close = _pipes(family, devices8, sdxl_trees, trees, sd3_trees, scheduler)
    port.set_stepwise(True)  # what apply_key_policy does for step keys
    h = port.distri_config.height
    key = ExecKey(model_id=family, scheduler=scheduler, height=h, width=h, steps=STEPS,
                  cfg=True, mesh_plan="dp1.cfg1.sp1", exec_mode="step")
    ex = PipelineExecutor(port, STEPS, key=key)
    assert _drive(ex, STEPS) >= 1
    # the port's step run against the JAX package's, on the same latents
    jpipe.set_stepwise(True)
    jex = JaxExecutor(jpipe, STEPS)
    lat = np.random.RandomState(3).randn(2, *ex._draw_latents([0]).shape[1:]).astype(
        np.float32)
    jex._draw_latents = lambda s: lat[:len(s)]
    ex._draw_latents = lambda s: torch.from_numpy(lat[:len(s)])
    jw, pw = jex.step_begin("a cat", "", 7, 5.0), ex.step_begin("a cat", "", 7, 5.0)
    for _ in range(STEPS):
        jex.step_run([jw])
        ex.step_run([pw])
    close(port.step_carry_latent(pw["carry"]).numpy(),
          np.asarray(jpipe.step_carry_latent(jw["carry"])))


def test_stepwise_timeline_records_each_step(sdxl_trees):  # noqa: F811
    from distrifuser_tpu_torch.utils.trace import StepTimeline

    pipe = _port_sdxl(sdxl_trees, step_cache_interval=2, step_cache_depth=1)
    tl = pipe.attach_step_timeline(StepTimeline())
    pipe(["a cat", "a dog"], num_inference_steps=4, output_type="latent")
    snap = tl.snapshot()
    assert snap["runs"] == 1
    # warmup 1 at one rank: steps 0-1 warmup, then shallow, full (the
    # step cache's shallow-first cadence)
    assert snap["phase_steps"] == {"warmup": 2, "full": 1, "shallow": 1}
    assert [s["step"] for s in snap["per_run"][0]["steps"]] == [0, 1, 2, 3]


# -- the transformer runners' stepwise API at 2 gloo ranks ----------------------


def test_transformer_stepwise_carries_at_two_ranks(devices8, tmp_path):
    import jax.numpy as jnp

    from distrifuser_tpu import DistriConfig as JaxDistriConfig
    from distrifuser_tpu.models import dit as jax_dit
    from distrifuser_tpu.models import mmdit as jax_mm
    from distrifuser_tpu.parallel.dit_sp import DiTDenoiseRunner as JaxDiT
    from distrifuser_tpu.parallel.mmdit_sp import MMDiTDenoiseRunner as JaxMMDiT
    from distrifuser_tpu.schedulers import get_scheduler as jax_scheduler
    from distrifuser_tpu_torch.models import dit as port_dit
    from distrifuser_tpu_torch.models import mmdit as port_mm
    from test_torch_port_pixart import _seeded
    from test_torch_port_ranks import run_ranks, transformer_stepwise_worker

    steps = 4
    rs = np.random.RandomState(5)
    jd, pd = _seeded(port_dit.init_dit_params, port_dit.tiny_dit_config(depth=2), 30)
    mcfg = dataclasses.replace(port_mm.tiny_mmdit_config(), depth=2)
    pm = port_mm.init_mmdit_params(torch.Generator().manual_seed(31), mcfg)
    jm = sd3_tests.jax_tree(pm)
    inp = {
        "steps": steps,
        "dit": {"params": pd, "latents": rs.randn(2, 16, 16, 4).astype(np.float32),
                "enc": rs.randn(2, 1, 7, 32).astype(np.float32),
                "extra": np.ones((2, 1, 7), np.float32)},
        "mmdit": {"params": pm, "latents": rs.randn(2, 32, 32, 4).astype(np.float32),
                  "enc": rs.randn(2, 1, 9, mcfg.joint_attention_dim).astype(np.float32),
                  "extra": rs.randn(2, 1, mcfg.pooled_projection_dim).astype(np.float32)},
    }
    torch.save(inp, tmp_path / "in.pt")
    wait = run_ranks(2, transformer_stepwise_worker, tmp_path, str(tmp_path / "in.pt"),
                     str(tmp_path / "out"), join=False)
    want = {}
    for name, runner_cls, jcfg, jp, sched, hw in (
            ("dit", JaxDiT, jax_dit.tiny_dit_config(depth=2), jd, "dpm-solver", 128),
            ("mmdit", JaxMMDiT, dataclasses.replace(jax_mm.tiny_mmdit_config(), depth=2),
             jm, "flow-euler", 256)):
        d = inp[name]
        cfg = JaxDistriConfig(devices=devices8[:2], height=hw, width=hw, warmup_steps=1,
                              split_batch=False, dtype=jnp.float32)
        runner = runner_cls(cfg, jcfg, jp, jax_scheduler(sched))
        carry = runner.stepwise_carry_init(jnp.asarray(d["latents"][:1]), steps)
        for i in range(steps):
            carry = runner.stepwise_carry_step(carry, i, jnp.asarray(d["enc"]),
                                               jnp.asarray(d["extra"]),
                                               jnp.asarray(4.5, jnp.float32), steps)
        want[name] = np.asarray(runner.stepwise_carry_latent(carry))
    wait()
    port = [torch.load(f"{tmp_path / 'out'}.rank{r}") for r in range(2)]
    for name in ("dit", "mmdit"):
        got = port[0][name]
        for a, b, g in zip(got["interleaved"], got["contiguous"], got["generate"]):
            assert torch.equal(a, b) and torch.equal(a, g), name
        assert torch.equal(port[1][name]["interleaved"][0], got["interleaved"][0])
        assert got["signatures"][0][1] == "sync" and got["signatures"][-1][1] == "stale"
        x, w = got["interleaved"][0].numpy(), want[name]
        assert np.abs(x - w).max() / np.abs(w).max() <= 5e-4, name
