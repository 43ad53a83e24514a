"""PyTorch port: replicas, the fleet router and the autoscaler (ROADMAP item
16e) against the JAX package's.

* Every scenario of tests/test_fleet.py and tests/test_autoscale.py runs
  once per package on the weightless fakes, with the same configs, fault
  plans, injected clocks and requests: both pass the JAX test's
  assertions and their records (lifecycle walks, routes, failovers, ledger
  counts, fired faults, scale events, snapshots) are equal.  The one JAX
  scenario that warms a replica from the AOT store runs without the store
  in both packages (the port refuses ``aot_cache.dir`` until step 16g).
* ``routing_weight``, ``fleet_pressure`` and ``Replica.health_score`` on a
  grid of inputs against the JAX functions.
* On the tiny SDXL pipeline, a two-replica step-batching fleet whose
  heavier replica the ``"replica"`` fault site kills after two denoise
  steps: the exported carry resumes on the survivor and finishes with the
  solo call's image bit for bit, the restarted replica serves its solo
  image again, and the JAX package's fleet, fed the same initial latents,
  gives the migrated image within the pipeline tests' 2e-4.
"""

import importlib
import json
import threading
import time
import types
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest
import torch

PACKAGES = ("distrifuser_tpu", "distrifuser_tpu_torch")
_MODULES = ("utils.config", "utils.metrics", "serve.faults", "serve.testing",
            "serve.replica", "serve.fleet", "serve.autoscale", "serve")
_PKGS = {}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's tiny models (restored after)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def pkg(name):
    if name not in _PKGS:
        ns = types.SimpleNamespace(name=name)
        for mod in _MODULES:
            m = importlib.import_module(f"{name}.{mod}")
            for k, v in vars(m).items():
                if not k.startswith("__"):
                    setattr(ns, k, v)
        _PKGS[name] = ns
    return _PKGS[name]


class ManualClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def wait_for(cond, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting: {msg}"
        time.sleep(0.002)


def serve_config(P, **kw):
    kw.setdefault("max_queue_depth", 64)
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("batch_window_s", 0.0)
    kw.setdefault("buckets", ((512, 512),))
    kw.setdefault("default_steps", 4)
    kw.setdefault("warmup_buckets", ((512, 512, 4),))
    return P.ServeConfig(**kw)


def mk_fleet(P, replicas, fleet_config=None, *, config=None, clock=None,
             fault_plans=None, step_time_s=0.0, ledger=None):
    registry = P.MetricsRegistry()
    ledger = ledger if ledger is not None else P.ExecutionLedger()
    reps = [P.Replica(name, P.LedgerFakeExecutorFactory(ledger, replica=name, batch_size=4,
                                                        step_time_s=step_time_s),
                      config or serve_config(P), capacity_weight=weight,
                      clock=clock or time.monotonic,
                      fault_plan=(fault_plans or {}).get(name), registry=registry)
            for name, weight in replicas]
    fleet = P.FleetRouter(reps, fleet_config or P.FleetConfig(tick_s=0),
                          clock=clock or time.monotonic, registry=registry)
    return fleet, ledger


def _states(history):
    return [(a, b) for _, a, b in history]


def _fleet_requests(fleet):
    return fleet.metrics_snapshot()["fleet"]["requests"]


# -- test_fleet.py's scenarios -------------------------------------------------


def routing_weight_math(P):
    rw = P.routing_weight
    assert rw(1.0, 2.0, 0) == 2.0
    assert rw(1.0, 2.0, 3) == pytest.approx(0.5)
    assert rw(0.2, 1.0, 0) < rw(1.0, 4.0, 3)
    assert rw(0.0, 100.0, 0) == 0.0
    return [rw(s, c, n) for s in (0.0, 0.2, 1.0) for c in (0.5, 1.0, 4.0) for n in (-1, 0, 3)]


def fleet_config_validation(P):
    msgs = []
    for kw, match in (({"health_floor": 1.5}, "health_floor"),
                      ({"drain_failure_threshold": 0}, "drain_failure_threshold"),
                      ({"max_failovers": -1}, "max_failovers"),
                      ({"p99_ref_s": 0.0}, "p99_ref_s"), ({"tick_s": -1.0}, "tick_s")):
        with pytest.raises(ValueError, match=match) as info:
            P.FleetConfig(**kw)
        msgs.append(str(info.value))
    for kw in ({"min_replicas": 0}, {"max_replicas": -1},
               {"min_replicas": 3, "max_replicas": 2}, {"pressure_high": 0.0},
               {"pressure_low": 0.9}, {"cooldown_s": -1.0}, {"drain_deadline_s": 0.0}):
        with pytest.raises(ValueError) as info:
            P.AutoscaleConfig(**kw)
        msgs.append(str(info.value))
    with pytest.raises(ValueError, match="AutoscaleConfig") as info:
        P.FleetConfig(autoscale={"enabled": True})
    return msgs + [str(info.value)]


def fault_rule_after_calls(P):
    plan = P.FaultPlan([P.FaultRule(site="s", kind="execute_error", p=1.0, after_calls=2)],
                       seed=0)
    plan.check("s")
    plan.check("s")
    with pytest.raises(Exception) as info:
        plan.check("s")
    with pytest.raises(ValueError, match="after_calls"):
        P.FaultRule(site="s", kind="oom", p=1.0, after_calls=-1)
    return type(info.value).__name__, plan.fired()


def kill_kind_raises_injected_replica_killed(P):
    plan = P.FaultPlan([P.FaultRule(site="replica", kind="kill", p=1.0)], seed=0)
    with pytest.raises(P.InjectedReplicaKilled) as info:
        plan.check("replica")
    return str(info.value), plan.fired()


def replica_lifecycle_walk(P):
    rep = P.Replica("r", P.FakeExecutorFactory(batch_size=4), serve_config(P))
    assert rep.state == P.REPLICA_STARTING
    rep.start()
    assert rep.state == P.REPLICA_SERVING
    assert [t for _, _, t in rep.history] == [P.REPLICA_WARMING, P.REPLICA_SERVING]
    assert rep.server.cache.stats()["misses"] == 1
    assert rep.server.aot_store is None and rep.last_warmup_deserialize_s == 0.0
    rep.drain()
    assert rep.state == P.REPLICA_DRAINING
    with pytest.raises(P.ServerClosedError):
        rep.submit("p", height=512, width=512)
    rep.resume()
    rep.stop()
    rep.stop()
    assert rep.state == P.REPLICA_STOPPED
    rep.start()
    assert rep.state == P.REPLICA_SERVING and rep.generation == 2
    r = rep.submit("p", height=512, width=512, seed=3).result(timeout=30)
    assert r.replica == "r"
    rep.stop()
    return _states(rep.history), r.output.tobytes(), rep.snapshot()


def replica_illegal_transitions_raise(P):
    rep = P.Replica("r", P.FakeExecutorFactory(batch_size=4), serve_config(P))
    rep.start()
    with pytest.raises(RuntimeError, match="cannot start") as info:
        rep.start()
    rep.stop()
    with pytest.raises(P.LifecycleError, match="illegal") as info2:
        rep._transition(P.REPLICA_SERVING)
    return type(info.value).__name__, str(info.value), str(info2.value)


def replica_probe_submit_path(P):
    rep = P.Replica("r", P.FakeExecutorFactory(batch_size=4), serve_config(P)).start()
    rep.drain()
    r = rep.submit("probe", height=512, width=512, probe=True).result(timeout=30)
    assert r.output is not None
    rep.stop()
    return r.output.tobytes()


def replica_drain_completes_inflight_work(P):
    rep = P.Replica("r", P.FakeExecutorFactory(batch_size=4, step_time_s=0.05),
                    serve_config(P)).start()
    futs = [rep.submit(f"p{i}", height=512, width=512, seed=i) for i in range(3)]
    rep.drain()
    results = [f.result(timeout=30) for f in futs]
    assert all(r.output is not None for r in results)
    wait_for(lambda: rep.drained)
    rep.stop()
    return [r.output.tobytes() for r in results], _states(rep.history)


def replica_capacity_weight_validation(P):
    with pytest.raises(ValueError, match="capacity_weight") as a:
        P.Replica("r", P.FakeExecutorFactory(), capacity_weight=0.0)
    with pytest.raises(ValueError, match="name") as b:
        P.Replica("", P.FakeExecutorFactory())
    return str(a.value), str(b.value)


def serve_result_pins_exec_key_tier_and_replica(P):
    factory = P.FakeExecutorFactory(batch_size=4)
    config = serve_config(P, controller=P.ControllerConfig(enabled=True,
                                                           slo_p99_s={"default": 30.0}))
    with P.InferenceServer(factory, config) as server:
        r = server.submit("p", height=512, width=512).result(timeout=30)
    assert r.tier == "full" and r.exec_key == factory.built[0].short()
    assert r.replica is None
    return r.tier, r.exec_key


def fleet_result_pins_replica_name(P):
    fleet, _ = mk_fleet(P, (("alpha", 1.0),))
    with fleet:
        r = fleet.submit("p", height=512, width=512).result(timeout=30)
    assert r.replica == "alpha" and r.exec_key
    return r.replica, r.exec_key


def shared_registry_replica_labels_do_not_collide(P):
    registry = P.MetricsRegistry()
    with P.InferenceServer(P.FakeExecutorFactory(batch_size=4), serve_config(P),
                           registry=registry, replica_name="a") as sa, \
            P.InferenceServer(P.FakeExecutorFactory(batch_size=4), serve_config(P),
                              registry=registry, replica_name="b") as sb:
        sa.submit("p", height=512, width=512).result(timeout=30)
        sb.submit("p", height=512, width=512).result(timeout=30)
        assert set(sa.slo_snapshot()["classes"]) == {"default"}
        assert sa.registry.family("serve_slo_e2e_seconds")[0][0]["replica"] == "a"
    labels = sorted(lbls.get("replica") for lbls, _ in registry.family("serve_requests"))
    assert labels == ["a", "b"]
    with pytest.raises(ValueError, match="already registered") as info:
        registry.gauge("serve_queue_depth", lambda: 0.0, labels={"replica": "a"})
    return labels, str(info.value)


def shared_registry_without_replica_name_collides_loudly(P):
    registry = P.MetricsRegistry()
    P.InferenceServer(P.FakeExecutorFactory(), serve_config(P), registry=registry)
    with pytest.raises(ValueError) as info:
        P.InferenceServer(P.FakeExecutorFactory(), serve_config(P), registry=registry)
    return str(info.value)


def scoped_registry_nesting_and_family_filter(P):
    base = P.MetricsRegistry()
    scoped = base.scoped({"replica": "r1"}).scoped({"generation": "2"})
    c = scoped.counter("x")
    c.inc("k")
    assert base.get("x", {"replica": "r1", "generation": "2"}) is c
    base.counter("x", labels={"replica": "r2"}).inc("k")
    assert len(base.family("x")) == 2 and len(scoped.family("x")) == 1
    return [lbls for lbls, _ in base.family("x")]


def one_replica_fleet_parity_with_bare_server(P):
    prompts = [(f"p{i}", i) for i in range(6)]
    with P.InferenceServer(P.FakeExecutorFactory(batch_size=4), serve_config(P)) as server:
        bare = [server.submit(p, height=512, width=512, seed=s).result(timeout=30)
                for p, s in prompts]
    fleet, _ = mk_fleet(P, (("r0", 1.0),))
    with fleet:
        fr = [fleet.submit(p, height=512, width=512, seed=s).result(timeout=30)
              for p, s in prompts]
    for b, f in zip(bare, fr):
        assert (b.output == f.output).all()
        assert b.bucket == f.bucket and b.batch_size >= 1
    snap = fleet.metrics_snapshot()
    assert snap["fleet"]["requests"]["completed"] == len(prompts)
    assert snap["replicas"]["r0"]["requests"]["completed"] == len(prompts)
    with pytest.raises(P.ServerClosedError) as info:
        fleet.submit("late", height=512, width=512)
    fleet.stop()
    return [f.output.tobytes() for f in fr], snap["fleet"]["requests"], str(info.value)


def failover_executes_exactly_once(P):
    plan = P.FaultPlan([P.FaultRule(site="execute", kind="execute_error", p=1.0,
                                    max_fires=1)], seed=0)
    cfg = serve_config(P, resilience=P.ResilienceConfig(max_retries=0))
    fleet, ledger = mk_fleet(P, (("heavy", 10.0), ("light", 1.0)), config=cfg,
                             fault_plans={"heavy": plan})
    with fleet:
        r = fleet.submit("only", height=512, width=512, seed=7).result(timeout=30)
    assert r.replica == "light" and ledger.count("only", 7) == 1
    assert ledger.snapshot()[("only", 7)] == ["light"]
    snap = _fleet_requests(fleet)
    assert snap["failovers"] == 1 and snap["replica_failures"] == 1
    return ledger.snapshot(), snap, r.output.tobytes()


def failover_budget_exhaustion_surfaces_the_error(P):
    plan = P.FaultPlan([P.FaultRule(site="execute", kind="execute_error", p=1.0)], seed=0)
    cfg = serve_config(P, resilience=P.ResilienceConfig(max_retries=0))
    fleet, _ = mk_fleet(P, (("r0", 1.0),), config=cfg, fault_plans={"r0": plan},
                        fleet_config=P.FleetConfig(tick_s=0, failover_budget=0,
                                                   failover_budget_refill_per_s=0.0,
                                                   drain_failure_threshold=100))
    with fleet:
        fut = fleet.submit("p", height=512, width=512)
        with pytest.raises(Exception) as info:
            fut.result(timeout=30)
    snap = _fleet_requests(fleet)
    assert snap.get("failover_budget_exhausted", 0) == 1
    return type(info.value).__name__, snap


def heterogeneous_weights_balance_one_slo(P):
    fleet, ledger = mk_fleet(P, (("heavy", 4.0), ("light", 1.0)), step_time_s=0.01)
    with fleet:
        futs = [fleet.submit(f"p{i}", height=512, width=512, seed=i, ttl_s=30.0)
                for i in range(20)]
        results = [f.result(timeout=60) for f in futs]
    assert all(r.output is not None for r in results)
    by_replica = {}
    for executions in ledger.snapshot().values():
        assert len(executions) == 1
        by_replica[executions[0]] = by_replica.get(executions[0], 0) + 1
    assert by_replica.get("heavy", 0) > by_replica.get("light", 0) > 0
    # which replica took which request follows the live queues; the
    # images do not
    return [r.output.tobytes() for r in results], ledger.max_count()


def auto_drain_and_half_open_reprobe(P):
    clock = ManualClock()
    plan = P.FaultPlan([P.FaultRule(site="execute", kind="execute_error", p=1.0,
                                    max_fires=3)], seed=0)
    cfg = serve_config(P, resilience=P.ResilienceConfig(max_retries=0,
                                                        breaker_failure_threshold=100))
    fleet, ledger = mk_fleet(P, (("flaky", 10.0), ("steady", 1.0)), config=cfg, clock=clock,
                             fault_plans={"flaky": plan},
                             fleet_config=P.FleetConfig(tick_s=0, probe_cooldown_s=10.0,
                                                        drain_failure_threshold=2,
                                                        max_failovers=4))
    routes = []
    with fleet:
        for i in range(2):
            routes.append(fleet.submit(f"p{i}", height=512, width=512,
                                       seed=i).result(timeout=30).replica)
        assert routes == ["steady", "steady"]
        assert fleet.replica("flaky").state == P.REPLICA_DRAINING
        snap = fleet.metrics_snapshot()["fleet"]
        assert snap["requests"]["auto_drains"] == 1 and snap["replicas"]["flaky"]["faulted"]
        routes.append(fleet.submit("p2", height=512, width=512, seed=2).result(30).replica)
        assert routes[-1] == "steady" and _fleet_requests(fleet).get("probes", 0) == 0
        clock.advance(11.0)
        routes.append(fleet.submit("p3", height=512, width=512, seed=3).result(30).replica)
        assert routes[-1] == "steady"
        s = _fleet_requests(fleet)
        assert s["probes"] == 1 and s["probe_failures"] == 1
        clock.advance(11.0)
        routes.append(fleet.submit("p4", height=512, width=512, seed=4).result(30).replica)
        assert routes[-1] == "flaky" and fleet.replica("flaky").state == P.REPLICA_SERVING
        assert _fleet_requests(fleet)["probe_successes"] == 1
        routes.append(fleet.submit("p5", height=512, width=512, seed=5).result(30).replica)
        assert routes[-1] == "flaky"
    assert ledger.max_count() == 1
    return routes, _fleet_requests(fleet), ledger.snapshot(), plan.fired()


def parked_request_redispatches_after_recovery(P):
    plan = P.FaultPlan([P.FaultRule(site="execute", kind="execute_error", p=1.0,
                                    max_fires=1)], seed=0)
    cfg = serve_config(P, resilience=P.ResilienceConfig(max_retries=0))
    fleet, ledger = mk_fleet(P, (("r0", 1.0), ("r1", 1.0)), config=cfg,
                             fault_plans={"r0": plan},
                             fleet_config=P.FleetConfig(tick_s=0, drain_failure_threshold=1,
                                                        probe_cooldown_s=1000.0))
    with fleet:
        fleet.drain_replica("r1")
        fut = fleet.submit("p", height=512, width=512, seed=1)
        wait_for(lambda: fleet.metrics_snapshot()["fleet"]["parked"] == 1)
        assert not fut.done()
        fleet.resume_replica("r1")
        fleet.tick()
        r = fut.result(timeout=30)
        assert r.replica == "r1"
    assert ledger.count("p", 1) == 1
    return ledger.snapshot(), _fleet_requests(fleet)


def no_healthy_replica_is_typed_rejection(P):
    fleet, _ = mk_fleet(P, (("r0", 1.0),))
    with fleet:
        fleet.drain_replica("r0")
        with pytest.raises(P.NoHealthyReplicaError) as info:
            fleet.submit("p", height=512, width=512)
    return str(info.value)


def fleet_stop_resolves_everything_deterministically(P):
    fleet, _ = mk_fleet(P, (("r0", 1.0), ("r1", 1.0)), step_time_s=0.05)
    fleet.start()
    futs = [fleet.submit(f"p{i}", height=512, width=512, seed=i) for i in range(8)]
    # stop lands with a batch on an executor (the JAX test's race, pinned)
    wait_for(lambda: any(fleet.replica(n).server._inflight_c.get("requests") > 0
                         for n in ("r0", "r1")))
    fleet.stop(timeout=10.0)
    fleet.stop(timeout=1.0)
    resolved = 0
    for f in futs:
        assert f.done()
        try:
            assert f.result(timeout=0).output is not None
            resolved += 1
        except P.ServerClosedError:
            pass
    assert resolved >= 1
    with pytest.raises(P.ServerClosedError) as info:
        fleet.submit("late", height=512, width=512)
    return all(f.done() for f in futs), str(info.value)


def stop_during_failover_race(P):
    plan = P.FaultPlan([P.FaultRule(site="execute", kind="execute_error", p=1.0)], seed=0)
    cfg = serve_config(P, resilience=P.ResilienceConfig(max_retries=0))
    fleet, _ = mk_fleet(P, (("r0", 10.0), ("r1", 1.0)), config=cfg, fault_plans={"r0": plan},
                        fleet_config=P.FleetConfig(tick_s=0, drain_failure_threshold=100))
    entered, release = threading.Event(), threading.Event()
    orig = P.FleetRouter._failover

    def gated_failover(self, fr, exc):
        entered.set()
        release.wait(10.0)
        orig(self, fr, exc)

    fleet._failover = types.MethodType(gated_failover, fleet)
    fleet.start()
    fleet.drain_replica("r1")
    fut = fleet.submit("p", height=512, width=512)
    assert entered.wait(10.0)
    stopper = threading.Thread(target=fleet.stop, kwargs={"timeout": 10.0})
    stopper.start()
    time.sleep(0.1)
    release.set()
    stopper.join(timeout=20.0)
    assert not stopper.is_alive() and fut.done()
    with pytest.raises(P.ServerClosedError) as info:
        fut.result(timeout=0)
    return type(info.value).__name__


def parked_request_expires_at_deadline(P):
    clock = ManualClock()
    plan = P.FaultPlan([P.FaultRule(site="execute", kind="execute_error", p=1.0,
                                    max_fires=1)], seed=0)
    cfg = serve_config(P, resilience=P.ResilienceConfig(max_retries=0))
    fleet, _ = mk_fleet(P, (("r0", 1.0),), config=cfg, clock=clock, fault_plans={"r0": plan},
                        fleet_config=P.FleetConfig(tick_s=0, drain_failure_threshold=1,
                                                   probe_cooldown_s=1000.0))
    with fleet:
        fut = fleet.submit("p", height=512, width=512, ttl_s=5.0)
        wait_for(lambda: fleet.metrics_snapshot()["fleet"]["parked"] == 1)
        clock.advance(6.0)
        fleet.tick()
        with pytest.raises(P.DeadlineExceededError) as info:
            fut.result(timeout=5)
    return str(info.value), _fleet_requests(fleet)


def replica_kill_fails_over_and_restart_recovers(P):
    ledger = P.ExecutionLedger()
    plan = P.FaultPlan([P.FaultRule(site="replica", kind="kill", key_substr="victim", p=1.0,
                                    max_fires=1, after_calls=2)], seed=0)
    cfg = serve_config(P, max_batch_size=2, resilience=P.ResilienceConfig(max_retries=0))
    registry = P.MetricsRegistry()
    reps = [P.Replica(name, P.LedgerFakeExecutorFactory(ledger, replica=name, batch_size=2,
                                                        step_time_s=0.005),
                      cfg, capacity_weight=w, fault_plan=plan, registry=registry)
            for name, w in (("victim", 1.0), ("survivor", 1.0))]
    fleet = P.FleetRouter(reps, P.FleetConfig(tick_s=0.02), registry=registry)
    with fleet:
        futs = []
        for i in range(16):
            futs.append(fleet.submit(f"p{i}", height=512, width=512, seed=i))
            time.sleep(0.01)
        results = [f.result(timeout=30) for f in futs]
        assert plan.fired() == {"replica/kill": 1}
        victim = fleet.replica("victim")
        assert victim.killed and victim.state == P.REPLICA_STOPPED
        fleet.restart_replica("victim")
        assert victim.state == P.REPLICA_SERVING and victim.generation == 2
        assert not victim.killed
        after = fleet.submit("after", height=512, width=512, seed=99).result(timeout=30)
    assert all(r.output is not None for r in results) and ledger.max_count() == 1
    return ([r.output.tobytes() for r in results], after.output.tobytes(),
            plan.fired(), _states(victim.history))


def redispatch_passes_remaining_ttl_not_a_fresh_one(P):
    clock = ManualClock()
    fleet, _ = mk_fleet(P, (("r0", 1.0),), clock=clock)
    with fleet:
        captured = {}
        server = fleet.replica("r0").server
        orig_submit = server.submit

        def spy(prompt, **kw):
            captured.update(kw)
            return orig_submit(prompt, **kw)

        server.submit = spy
        params = dict(prompt="x", height=512, width=512, negative_prompt="",
                      num_inference_steps=None, guidance_scale=5.0, seed=0, ttl_s=9.0,
                      slo_class="default")
        fr = P._FleetRequest(params=params, future=Future(), deadline=clock() + 4.0)
        ok, _ = fleet._try_dispatch(fr)
        assert ok and captured["ttl_s"] == pytest.approx(4.0)
        fr.future.result(timeout=30)
        fr2 = P._FleetRequest(params=dict(params), future=Future(), deadline=clock() - 1.0)
        ok, exc = fleet._try_dispatch(fr2)
        assert ok and exc is None
        with pytest.raises(P.DeadlineExceededError) as info:
            fr2.future.result(timeout=5)
    return captured["ttl_s"], str(info.value)


def restart_prunes_dead_generation_metrics(P):
    registry = P.MetricsRegistry()
    rep = P.Replica("r", P.FakeExecutorFactory(batch_size=4), serve_config(P),
                    registry=registry)
    rep.start()
    rep.submit("p", height=512, width=512).result(timeout=30)
    gen1 = {"replica": "r", "generation": "1"}
    assert registry.get("serve_requests", gen1) is not None
    rep.stop()
    rep.start()
    assert registry.get("serve_requests", gen1) is None
    assert registry.get("serve_requests", {"replica": "r", "generation": "2"}) is not None
    rep.stop()
    return sorted(tuple(sorted(lbls.items())) for lbls, _ in
                  registry.family("serve_requests"))


def stop_stays_responsive_during_warmup(P):
    rep = P.Replica("r", P.FakeExecutorFactory(batch_size=4, build_delay_s=0.5),
                    serve_config(P))
    t = threading.Thread(target=rep.start)
    t.start()
    wait_for(lambda: rep.state == P.REPLICA_WARMING, timeout=5)
    t0 = time.monotonic()
    rep.stop(timeout=5.0)
    assert time.monotonic() - t0 < 0.4
    t.join(timeout=10)
    assert rep.state == P.REPLICA_STOPPED and rep.server is None
    with pytest.raises(P.ServerClosedError) as info:
        rep.submit("p", height=512, width=512)
    return _states(rep.history), str(info.value)


def request_fatal_errors_do_not_drain_healthy_replicas(P):
    fleet, _ = mk_fleet(P, (("r0", 1.0), ("r1", 1.0)),
                        fleet_config=P.FleetConfig(tick_s=0, drain_failure_threshold=2))
    with fleet:
        errs = []
        for i in range(6):
            fut = fleet.submit(f"poison{i}", height=8192, width=8192)
            with pytest.raises(Exception) as info:
                fut.result(timeout=30)
            errs.append(type(info.value).__name__)
        snap = fleet.metrics_snapshot()["fleet"]
        assert snap["requests"].get("auto_drains", 0) == 0
        assert snap["requests"]["failed_fatal"] == 6
        for entry in snap["replicas"].values():
            assert entry["state"] == P.REPLICA_SERVING and not entry["faulted"]
        r = fleet.submit("ok", height=512, width=512).result(timeout=30)
    return errs, snap["requests"], r.output.tobytes()


def fleet_start_is_parallel(P):
    registry = P.MetricsRegistry()
    reps = [P.Replica(f"r{i}", P.FakeExecutorFactory(batch_size=4, build_delay_s=0.3),
                      serve_config(P), registry=registry) for i in range(3)]
    fleet = P.FleetRouter(reps, P.FleetConfig(tick_s=0), registry=registry)
    t0 = time.monotonic()
    fleet.start()
    elapsed = time.monotonic() - t0
    fleet.stop()
    assert elapsed < 0.75, elapsed
    return [r.state for r in reps]


def fleet_start_failure_stops_started_replicas(P):
    class ExplodingReplica(P.Replica):
        def start(self):
            raise RuntimeError("injected start failure")

    registry = P.MetricsRegistry()
    good = P.Replica("good", P.FakeExecutorFactory(batch_size=4), serve_config(P),
                     registry=registry)
    bad = ExplodingReplica("bad", P.FakeExecutorFactory(batch_size=4), serve_config(P),
                           registry=registry)
    fleet = P.FleetRouter([good, bad], P.FleetConfig(tick_s=0), registry=registry)
    with pytest.raises(RuntimeError, match="failed to start") as info:
        fleet.start()
    assert good.state == P.REPLICA_STOPPED
    return type(info.value).__name__, str(info.value)


def kill_is_terminal_even_with_retries_enabled(P):
    ledger = P.ExecutionLedger()
    plan = P.FaultPlan([P.FaultRule(site="replica", kind="kill", key_substr="victim", p=1.0,
                                    max_fires=1)], seed=0)
    cfg = serve_config(P, resilience=P.ResilienceConfig(max_retries=5, backoff_base_s=0.001,
                                                        backoff_max_s=0.01))
    registry = P.MetricsRegistry()
    reps = [P.Replica(name, P.LedgerFakeExecutorFactory(ledger, replica=name, batch_size=4),
                      cfg, capacity_weight=w, fault_plan=plan, registry=registry)
            for name, w in (("victim", 10.0), ("survivor", 1.0))]
    fleet = P.FleetRouter(reps, P.FleetConfig(tick_s=0), registry=registry)
    with fleet:
        r = fleet.submit("only", height=512, width=512, seed=1).result(timeout=30)
    assert r.replica == "survivor"
    assert ledger.snapshot()[("only", 1)] == ["survivor"]
    assert plan.fired() == {"replica/kill": 1} and fleet.replica("victim").killed
    return ledger.snapshot(), plan.fired(), _fleet_requests(fleet), r.output.tobytes()


def rebuilt_fleet_over_same_replicas_and_registry(P):
    registry = P.MetricsRegistry()
    reps = [P.Replica(f"r{i}", P.FakeExecutorFactory(batch_size=4), serve_config(P),
                      registry=registry) for i in range(2)]
    fleet1 = P.FleetRouter(reps, P.FleetConfig(tick_s=0), registry=registry)
    with fleet1:
        fleet1.submit("p", height=512, width=512).result(timeout=30)
    with pytest.raises(P.ServerClosedError, match="build a new") as a:
        fleet1.start()
    fleet2 = P.FleetRouter(reps, P.FleetConfig(tick_s=0), registry=registry)
    with fleet2:
        r = fleet2.submit("q", height=512, width=512).result(timeout=30)
        with pytest.raises(RuntimeError, match="already started") as b:
            fleet2.start()
        assert all(s.replica.state == P.REPLICA_SERVING for s in fleet2._slots.values())
    return str(a.value), str(b.value), r.output.tobytes()


def auto_restart_cannot_resurrect_after_stop(P):
    fleet, _ = mk_fleet(P, (("r0", 1.0),),
                        fleet_config=P.FleetConfig(tick_s=0, auto_restart=True,
                                                   restart_cooldown_s=0.0))
    fleet.start()
    slot = fleet._slots["r0"]
    fleet.stop()
    fleet._restart_async(slot)
    wait_for(lambda: not slot.restarting, timeout=5)
    assert fleet.replica("r0").state == P.REPLICA_STOPPED
    msgs = []
    for op in (fleet.restart_replica, fleet.drain_replica):
        with pytest.raises(P.ServerClosedError) as info:
            op("r0")
        msgs.append(str(info.value))
    assert fleet.replica("r0").state == P.REPLICA_STOPPED
    return msgs


def fleet_health_snapshot_shape(P):
    fleet, _ = mk_fleet(P, (("a", 1.0), ("b", 2.0)))
    with fleet:
        fleet.submit("p", height=512, width=512).result(timeout=30)
        h = fleet.health()
        assert h["status"] == "ok"
        assert h["serving_replicas"] == 2 and h["total_replicas"] == 2
        assert set(h["replicas"]) == {"a", "b"}
        for entry in h["replicas"].values():
            assert entry["state"] == P.REPLICA_SERVING and 0.0 <= entry["score"] <= 1.0
        json.dumps(fleet.metrics_snapshot())
        json.dumps(h)
    return sorted(h), {n: sorted(e) for n, e in h["replicas"].items()}


# -- test_autoscale.py's scenarios ---------------------------------------------


def autoscale_cfg(P, **kw):
    kw.setdefault("enabled", True)
    kw.setdefault("min_replicas", 1)
    kw.setdefault("pressure_high", 0.8)
    kw.setdefault("pressure_low", 0.1)
    kw.setdefault("up_sustain_s", 0.0)
    kw.setdefault("down_sustain_s", 0.0)
    kw.setdefault("cooldown_s", 0.0)
    kw.setdefault("drain_deadline_s", 5.0)
    return P.AutoscaleConfig(**kw)


def serve_cfg(P, **kw):
    kw.setdefault("warmup_buckets", ((64, 64, 2),))
    kw.setdefault("default_steps", 2)
    kw.setdefault("max_queue_depth", 64)
    kw.setdefault("default_ttl_s", 60.0)
    return P.ServeConfig(**kw)


def mk_scaled_fleet(P, n=3, *, factory=None, autoscale=None, serve=None, **fleet_kw):
    factory = factory or P.FakeExecutorFactory()
    fleet_kw.setdefault("tick_s", 0.0)
    fc = P.FleetConfig(autoscale=autoscale or autoscale_cfg(P), **fleet_kw)
    return P.build_fleet(lambda name: factory, serve or serve_cfg(P), fc,
                         replicas=[(f"r{i}", 1.0) for i in range(n)])


def fleet_pressure_math(P):
    fp = P.fleet_pressure
    assert fp(0.0, 4.0) == 0.0 and fp(2.0, 4.0) == 0.5 and fp(8.0, 4.0) == 2.0
    assert fp(0.0, 0.0) == 0.0 and fp(1.0, 0.0) == float("inf")
    return [fp(d, c) for d in (0.0, 0.5, 3.0, 9.0) for c in (0.0, 1.0, 4.0)]


def autoscaler_absent_by_default(P):
    router = mk_scaled_fleet(P, 2, autoscale=P.AutoscaleConfig())
    assert router.autoscaler is None
    with router:
        states = [router.replica(n).state for n in router.replica_names()]
    assert states == [P.REPLICA_SERVING] * 2
    return states


def start_warms_only_min_replicas(P):
    router = mk_scaled_fleet(P, 3, autoscale=autoscale_cfg(P, min_replicas=1))
    with router:
        states = [router.replica(n).state for n in ("r0", "r1", "r2")]
        assert states == [P.REPLICA_SERVING, P.REPLICA_STARTING, P.REPLICA_STARTING]
        assert router.autoscaler.active_count() == 1
        out = router.submit("p", height=64, width=64, num_inference_steps=2).result(30)
        assert out.replica == "r0"
    gens = [router.replica(n).generation for n in router.replica_names()]
    assert gens == [1, 0, 0]
    return states, gens, out.output.tobytes()


def scale_up_on_sustained_queue_pressure(P):
    """tests/test_autoscale.py's scale-up, without the AOT store (the
    port refuses ``aot_cache.dir`` until step 16g)."""
    factory = P.FakeExecutorFactory(build_delay_s=0.05, step_time_s=0.05)
    router = mk_scaled_fleet(P, 3, factory=factory, serve=serve_cfg(P, max_batch_size=1),
                             autoscale=autoscale_cfg(P, max_replicas=2))
    with router:
        a = router.autoscaler
        futs = [router.submit(f"p{i}", height=64, width=64, num_inference_steps=2, seed=i)
                for i in range(8)]
        assert a.pressure() > a.config.pressure_high
        wait_for(lambda: (router.tick() or router.replica("r1").state == P.REPLICA_SERVING),
                 msg="scale-up to r1")
        assert a.counters.snapshot()["scale_ups"] == 1 and a.active_count() == 2
        outs = [f.result(timeout=30).output.tobytes() for f in futs]
    snap = router.metrics_snapshot()["fleet"]
    assert snap["autoscale"]["counters"]["scale_ups"] == 1
    return outs, snap["autoscale"]["counters"]["scale_ups"], router.replica("r2").state


def scale_up_respects_max_replicas(P):
    factory = P.FakeExecutorFactory(step_time_s=0.05)
    router = mk_scaled_fleet(P, 3, factory=factory, serve=serve_cfg(P, max_batch_size=1),
                             autoscale=autoscale_cfg(P, max_replicas=1))
    with router:
        a = router.autoscaler
        futs = [router.submit(f"p{i}", height=64, width=64, num_inference_steps=2, seed=i)
                for i in range(6)]
        router.tick()
        cnt = a.counters.snapshot()
        assert cnt.get("up_blocked_max", 0) >= 1 and cnt.get("scale_ups", 0) == 0
        assert a.active_count() == 1
        outs = [f.result(timeout=30).output.tobytes() for f in futs]
    return outs, cnt.get("scale_ups", 0)


def _step_serve_cfg(P):
    return P.ServeConfig(max_queue_depth=32, max_batch_size=4, batch_window_s=0.001,
                         buckets=((64, 64),), warmup_buckets=(), default_steps=4,
                         default_ttl_s=60.0,
                         step_batching=P.StepBatchConfig(enabled=True, slots=4))


def scale_down_salvages_in_flight_steps(P):
    registry, ledger = P.MetricsRegistry(), P.ExecutionLedger()
    cfg = _step_serve_cfg(P)
    reps = [P.Replica(n, P.StepLedgerFakeExecutorFactory(ledger, replica=n, batch_size=4,
                                                         step_time_s=0.02),
                      cfg, registry=registry) for n in ("r0", "r1")]
    router = P.FleetRouter(reps, P.FleetConfig(tick_s=0.0), registry=registry)
    with router:
        a = P.Autoscaler(router, autoscale_cfg(P, min_replicas=1, pressure_low=0.5,
                                               drain_deadline_s=0.2))
        router.autoscaler = a
        f0 = router.submit("keep", height=64, width=64, seed=1, num_inference_steps=60)
        f1 = router.submit("move", height=64, width=64, seed=2, num_inference_steps=60)
        wait_for(lambda: all(len(r.server.stepbatch.occupied()) == 1
                             and all(s.steps_done >= 2 for s in r.server.stepbatch.occupied())
                             for r in reps), msg="one request resident per replica")
        assert a.pressure() <= 0.5
        assert a.tick() == "down"
        wait_for(lambda: router.replica("r1").state == P.REPLICA_STOPPED, msg="released")
        outs = [f0.result(timeout=30), f1.result(timeout=30)]
    moved = outs[1]
    assert moved.replica == "r0" and moved.migrations == 1 and moved.steps_salvaged >= 2
    assert ledger.max_step_count() == 1
    snap = _fleet_requests(router)
    assert snap.get("fleet_steps_reexecuted", 0) == 0 and snap["steps_salvaged"] >= 2
    assert a.counters.snapshot()["scale_downs"] == 1
    # how far the victim got before the deadline follows the wall clock;
    # which steps ran where, and the images, do not
    return ([o.output.tobytes() for o in outs], moved.replica, moved.migrations,
            sorted(ledger.step_counts("move", 2)) == list(range(60)),
            a.counters.snapshot()["scale_downs"])


def scale_down_respects_min_replicas(P):
    router = mk_scaled_fleet(P, 2, autoscale=autoscale_cfg(P, min_replicas=1))
    with router:
        a = router.autoscaler
        for _ in range(3):
            router.tick()
        assert a.active_count() == 1
        cnt = a.counters.snapshot()
        assert cnt.get("scale_downs", 0) == 0 and cnt.get("down_blocked_min", 0) >= 1
    return cnt


def sustain_and_cooldown_injected_clock(P):
    clock = ManualClock(0.0)
    factory = P.FakeExecutorFactory()
    fc = P.FleetConfig(tick_s=0.0, autoscale=autoscale_cfg(
        P, min_replicas=1, max_replicas=3, up_sustain_s=1.0, down_sustain_s=2.0,
        cooldown_s=5.0))
    router = P.build_fleet(lambda name: factory, serve_cfg(P), fc,
                           replicas=[("r0", 1.0), ("r1", 1.0), ("r2", 1.0)], clock=clock)
    decisions = []
    with router:
        a = router.autoscaler
        demand = {"v": 10.0}
        a.pressure = lambda: demand["v"]

        def tick(now):
            decisions.append((now, a.tick(now=now)))
            return decisions[-1][1]

        assert tick(0.0) is None and tick(0.5) is None and tick(1.0) == "up"
        wait_for(lambda: not a.snapshot()["op_inflight"])
        assert router.replica("r1").state == P.REPLICA_SERVING
        assert tick(1.1) is None and tick(5.9) is None and tick(6.5) == "up"
        wait_for(lambda: not a.snapshot()["op_inflight"])
        assert a.active_count() == 3
        demand["v"] = 0.0
        assert tick(11.6) is None and tick(12.6) is None and tick(13.7) == "down"
        wait_for(lambda: not a.snapshot()["op_inflight"])
        assert a.active_count() == 2
        demand["v"] = 10.0
        assert tick(18.8) is None
        demand["v"] = 0.0
        assert tick(18.9) is None and tick(19.9) is None
        cnt = a.counters.snapshot()
        assert cnt["scale_ups"] == 2 and cnt["scale_downs"] == 1
    return decisions, cnt


SCENARIOS = {f.__name__: f for f in (
    routing_weight_math, fleet_config_validation, fault_rule_after_calls,
    kill_kind_raises_injected_replica_killed, replica_lifecycle_walk,
    replica_illegal_transitions_raise, replica_probe_submit_path,
    replica_drain_completes_inflight_work, replica_capacity_weight_validation,
    serve_result_pins_exec_key_tier_and_replica, fleet_result_pins_replica_name,
    shared_registry_replica_labels_do_not_collide,
    shared_registry_without_replica_name_collides_loudly,
    scoped_registry_nesting_and_family_filter, one_replica_fleet_parity_with_bare_server,
    failover_executes_exactly_once, failover_budget_exhaustion_surfaces_the_error,
    heterogeneous_weights_balance_one_slo, auto_drain_and_half_open_reprobe,
    parked_request_redispatches_after_recovery, no_healthy_replica_is_typed_rejection,
    fleet_stop_resolves_everything_deterministically, stop_during_failover_race,
    parked_request_expires_at_deadline, replica_kill_fails_over_and_restart_recovers,
    redispatch_passes_remaining_ttl_not_a_fresh_one, restart_prunes_dead_generation_metrics,
    stop_stays_responsive_during_warmup, request_fatal_errors_do_not_drain_healthy_replicas,
    fleet_start_is_parallel, fleet_start_failure_stops_started_replicas,
    kill_is_terminal_even_with_retries_enabled, rebuilt_fleet_over_same_replicas_and_registry,
    auto_restart_cannot_resurrect_after_stop, fleet_health_snapshot_shape,
    fleet_pressure_math, autoscaler_absent_by_default, start_warms_only_min_replicas,
    scale_up_on_sustained_queue_pressure, scale_up_respects_max_replicas,
    scale_down_salvages_in_flight_steps, scale_down_respects_min_replicas,
    sustain_and_cooldown_injected_clock)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fleet_scenario_matches_jax(name):
    # the two packages' runs overlap on two threads: the scenarios wait on
    # sleeps and fakes, not on the CPU
    pkgs = [pkg(n) for n in PACKAGES]
    with ThreadPoolExecutor(2) as pool:
        want, got = [f.result() for f in [pool.submit(SCENARIOS[name], P) for P in pkgs]]
    assert got == want


def test_health_score_matches_jax_over_breakers_tiers_and_p99():
    """`Replica.health_score` on live fake servers whose breaker states,
    controller tiers and SLO windows are set by hand, against the JAX
    replica's on the same settings."""
    scores = []
    for name in PACKAGES:
        P = pkg(name)
        cfg = serve_config(P, controller=P.ControllerConfig(enabled=True,
                                                            slo_p99_s={"default": 30.0}))
        rep = P.Replica("r", P.FakeExecutorFactory(batch_size=4), cfg)
        row = [rep.health_score()]  # not started: 0
        rep.start()
        srv = rep.server
        for tier in (0, 2, 5):
            srv.controller._state("default").tier = tier
            srv.controller._state("premium").tier = max(0, tier - 1)
            for p99 in (None, 0.5, 4.0):
                if p99 is not None:
                    srv.slo_window("default").observe(p99)
                for ref in (None, 1.0, 2.0):
                    row.append(round(rep.health_score(ref), 12))
        rep.drain()
        row.append(rep.health_score())  # draining: 0
        rep.stop()
        scores.append(row)
    assert scores[1] == scores[0]
    assert 0.0 < min(scores[0][1:-1]) and max(scores[0]) <= 1.0


# -- the tiny SDXL pipeline: a replica killed mid-denoise ----------------------


from test_torch_port_serve_pipeline import (  # noqa: E402
    SDXL_TOL, _jax_sdxl, _port_sdxl, sdxl_trees)  # noqa: F401 -- fixture

STEPS = 4
KILL_AFTER = 2


def _kill_fleet(P, factory_for, ledger_box, warmup=True):
    """r0 (weight 10, takes the first request) dies at its third step call;
    r1 survives.  Step batching exports r0's carry for r1 to resume."""
    plan = P.FaultPlan([P.FaultRule(site="replica", kind="kill", key_substr="r0", p=1.0,
                                    max_fires=1, after_calls=KILL_AFTER)], seed=0)
    cfg = P.ServeConfig(
        buckets=((128, 128),), max_batch_size=2, batch_window_s=0.001, default_steps=STEPS,
        warmup_buckets=((128, 128, STEPS),) if warmup else (), max_queue_depth=16,
        default_ttl_s=600.0,
        resilience=P.ResilienceConfig(max_retries=0),
        step_batching=P.StepBatchConfig(enabled=True, slots=2))
    registry = P.MetricsRegistry()
    reps = [P.Replica(n, factory_for(n), cfg, capacity_weight=w, fault_plan=plan,
                      registry=registry, model_id="tiny-sdxl")
            for n, w in (("r0", 10.0), ("r1", 1.0))]
    ledger_box["plan"] = plan
    return P.FleetRouter(reps, P.FleetConfig(tick_s=0), registry=registry)


def test_killed_replica_carry_migrates_bit_for_bit_and_matches_jax(devices8, sdxl_trees):
    from distrifuser_tpu.serve.executors import pipeline_executor_factory as jax_factory
    from distrifuser_tpu_torch.serve import pipeline_executor_factory

    T, J = pkg(PACKAGES[1]), pkg(PACKAGES[0])
    prompt, seed = "a lighthouse at dusk", 41
    pipes = {}

    def port_factory_for(name):
        def build(key):
            pipes[name] = _port_sdxl(sdxl_trees)
            return pipes[name]
        return pipeline_executor_factory(build)

    box = {}
    fleet = _kill_fleet(T, port_factory_for, box)
    with fleet:
        r = fleet.submit(prompt, height=128, width=128, seed=seed).result(timeout=300)
        assert box["plan"].fired() == {"replica/kill": 1}
        assert fleet.replica("r0").killed
        assert (r.replica, r.migrations, r.steps_salvaged) == ("r1", 1, KILL_AFTER)
        solo = pipes["r1"](prompt, seed=seed, num_inference_steps=STEPS,
                           output_type="np").images[0]
        np.testing.assert_array_equal(r.output, solo)
        snap = _fleet_requests(fleet)
        assert snap["steps_salvaged"] == KILL_AFTER
        # the restarted replica (a fresh generation, its executor rebuilt)
        # serves its solo image again
        fleet.restart_replica("r0")
        assert fleet.replica("r0").generation == 2
        r2 = fleet.submit("a corgi on a skateboard", height=128, width=128,
                          seed=42).result(timeout=300)
        assert r2.replica == "r0" and r2.migrations == 0
        solo2 = pipes["r0"]("a corgi on a skateboard", seed=42, num_inference_steps=STEPS,
                            output_type="np").images[0]
        np.testing.assert_array_equal(r2.output, solo2)

    # the JAX package's fleet, fed the port's solo call's initial latents
    # (one JAX pipeline, built on first use, serves both replicas)
    sigma = float(pipes["r1"].scheduler.init_noise_sigma)
    lat = np.random.RandomState(seed).randn(1, 16, 16, 4).astype(np.float32) * sigma
    want = pipes["r1"](prompt, latents=torch.from_numpy(lat), num_inference_steps=STEPS,
                       output_type="np").images[0]
    shared = []

    def jax_build(key):
        if not shared:
            shared.append(_jax_sdxl(devices8, sdxl_trees))
        return shared[0]

    def jax_factory_for(name, _inner=jax_factory(jax_build)):
        def make(key):
            ex = _inner(key)
            ex._draw_latents = lambda seeds: np.concatenate([lat] * len(seeds))
            return ex
        return make

    with _kill_fleet(J, jax_factory_for, box, warmup=False) as f:
        out = f.submit(prompt, height=128, width=128, seed=seed).result(timeout=300)
    assert (out.replica, out.migrations, out.steps_salvaged) == ("r1", 1, KILL_AFTER)
    np.testing.assert_allclose(np.asarray(out.output), want, rtol=0, atol=SDXL_TOL)


def test_launch_counts_of_threads_sharing_a_card_stay_exact():
    """Replicas sharing a card launch from several threads at once, and one
    may capture a CUDA graph while another launches: every count is added
    under one lock, and a capturing thread's launches go to its own tally
    (``launch_tally``, what a graph then adds at each replay), never mixed
    with another thread's."""
    from distrifuser_tpu_torch.ops import flash_attention as fa
    from distrifuser_tpu_torch.ops import quant_matmul as qm
    from distrifuser_tpu_torch.ops._build import add_launches, launch_tally

    before = (fa.flash_sdpa.launches, qm.quant_matmul.launches,
              fa.flash_sdpa.launches_by_head_dim[64])
    tallies = []

    def capture():
        with launch_tally() as tally:
            for _ in range(2000):
                add_launches(fa.flash_sdpa, head_dim=64)
            with launch_tally() as inner:
                add_launches(qm.quant_matmul, 3)
            tallies.append((dict(tally), dict(inner)))

    def serve():
        for _ in range(20000):
            add_launches(fa.flash_sdpa)
            add_launches(qm.quant_matmul)

    threads = [threading.Thread(target=f) for f in (serve, capture, serve)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fa.flash_sdpa.launches - before[0] == 40000
    assert qm.quant_matmul.launches - before[1] == 40000
    assert tallies == [({(fa.flash_sdpa, "launches"): 2000},
                        {(qm.quant_matmul, "launches"): 3})]
    # the by-head-dim counts stay an eager call's, capture or not
    assert fa.flash_sdpa.launches_by_head_dim[64] - before[2] == 2000
