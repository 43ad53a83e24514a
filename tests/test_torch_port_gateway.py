"""PyTorch port: tenancy and the HTTP/SSE gateway (ROADMAP item 16d)
against the JAX package's.

* Every scenario of tests/test_gateway.py runs once per package on the
  weightless fakes, with the same configs, clocks and requests: both pass
  the JAX test's assertions and their records (admissions, rejections and
  their HTTP bodies, DRR dequeue orders, SSE event names and sequence
  numbers, decoded images, tenancy snapshots, failover routes) are equal
  -- the token bucket, tenant validation, typed quota rejections, DRR
  shares, idempotent peeks, starvation freedom, the rescue peek, forfeited
  deficits, quota before depth, the event buffer's drop-oldest and
  terminal rules, the SSE wire format, the gateway core over a stub
  backend (400 / 404 / cancel / late cancel / 429 / stop), HTTP round trips
  on an ephemeral 127.0.0.1 port (wire = in-process byte for byte, tenant
  429, bad JSON, cancel, backpressure, a fleet-fronted failover, stop with
  a stream open), the shared HTTP host's rebind and the metrics endpoint.
* The DRR pick and the token bucket on a seeded random workload, and
  `encode_image` / `decode_image` across the packages byte for byte
  (float32, uint8, bfloat16 -- a JAX bf16 array's bytes against a torch
  bf16 tensor's -- and a tensor handed to the port's encoder).
* On the tiny SDXL pipeline, a step-batching server behind the gateway
  serves over the wire the image its in-process ``submit`` and the solo
  call give, bit for bit; the JAX package's, fed the initial latents of the
  port's solo calls, gives wire images within the pipeline tests' 2e-4 of
  theirs.
"""

import importlib
import json
import threading
import time
import types
import urllib.error
import urllib.request
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest
import torch

PACKAGES = ("distrifuser_tpu", "distrifuser_tpu_torch")
_MODULES = ("utils.config", "utils.metrics", "serve.queue", "serve.tenancy",
            "serve.testing", "serve.faults", "serve.gateway", "serve")
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
        ns.sync = importlib.import_module(f"{name}.utils.sync")
        _PKGS[name] = ns
    return _PKGS[name]


def serve_config(P, **kw):
    kw.setdefault("max_queue_depth", 64)
    kw.setdefault("batch_window_s", 0.001)
    kw.setdefault("buckets", ((64, 64),))
    kw.setdefault("warmup_buckets", ())
    kw.setdefault("default_steps", 4)
    kw.setdefault("default_ttl_s", 60.0)
    kw.setdefault("step_batching", P.StepBatchConfig(enabled=True, slots=4,
                                                     preview_interval=1))
    kw.setdefault("gateway", P.GatewayConfig(port=0))
    return P.ServeConfig(**kw)


def mk_request(P, prompt="p", steps=1, tenant="default", ttl=60.0, seed=0):
    now = time.monotonic()
    return P.Request(prompt=prompt, height=64, width=64, num_inference_steps=steps,
                     deadline=now + ttl, seed=seed, tenant=tenant, enqueue_ts=now)


def post_json(url, body, timeout=15):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def read_sse(url, timeout=30):
    events = []
    with urllib.request.urlopen(url, timeout=timeout) as r:
        name = None
        for line in r:
            line = line.decode().rstrip("\n")
            if line.startswith("event: "):
                name = line[7:]
            elif line.startswith("data: "):
                events.append((name, json.loads(line[6:])))
    return events


class StubBackend:
    def __init__(self):
        self.calls = []

    def submit(self, prompt, **kw):
        f = Future()
        self.calls.append((prompt, kw, f))
        return f


def _untimed(tenancy):
    """A tenancy snapshot without the token levels, which a real clock's
    refill between requests sets."""
    return {t: {k: v for k, v in row.items() if k != "tokens"}
            for t, row in tenancy.items()}


def _strip(body):
    """An HTTP error body without the free-text message's port-specific
    wording (type, retryable and fatal are the contract)."""
    return {k: v for k, v in body.items() if k != "message"}


# -- the scenarios: each asserts the JAX test's claims and returns a record --


def token_bucket_refill_and_burst(P):
    t = [0.0]
    b = P.TokenBucket(rate=2.0, burst=2.0, clock=lambda: t[0])
    takes = [b.try_take(), b.try_take(), b.try_take()]
    t[0] = 0.5
    takes += [b.try_take(), b.try_take()]
    t[0] = 100.0
    takes += [b.try_take(), b.try_take(), b.try_take()]
    assert takes == [True, True, False, True, False, True, True, False]
    return takes


def unlimited_bucket_never_rejects(P):
    b = P.TokenBucket(rate=0.0, burst=0.0, clock=lambda: 0.0)
    assert all(b.try_take() for _ in range(1000))
    return True


def tenant_config_validation(P):
    msgs = []
    for kw, match in (({"name": "a", "weight": 0.0}, "weight"),
                      ({"name": "a", "rate_rps": -1.0}, "rate_rps"),
                      ({"name": ""}, "name")):
        with pytest.raises(ValueError, match=match) as info:
            P.TenantConfig(**kw)
        msgs.append(str(info.value))
    assert P.TenantConfig(name="a", rate_rps=3.0).burst == 3.0
    with pytest.raises(ValueError, match="duplicate") as info:
        P.GatewayConfig(tenants=(P.TenantConfig(name="a"), P.TenantConfig(name="a")))
    return msgs + [str(info.value)]


def quota_rejection_is_typed_and_counted(P):
    cfg = P.GatewayConfig(tenants=(P.TenantConfig(name="t", rate_rps=0.001, burst=2.0),))
    pol = P.TenancyPolicy(cfg, clock=lambda: 0.0)
    pol.admit(mk_request(P, tenant="t"))
    pol.admit(mk_request(P, tenant="t"))
    with pytest.raises(P.TenantQuotaError) as e1:
        pol.admit(mk_request(P, tenant="t"))
    with pytest.raises(P.TenantQuotaError, match="unknown tenant") as e2:
        pol.admit(mk_request(P, tenant="nobody"))
    snap = pol.snapshot()
    assert snap["t"]["admitted"] == 2 and snap["t"]["rejected_quota"] == 1
    return str(e1.value), str(e2.value), snap


def drr_share_follows_weights(P):
    cfg = P.GatewayConfig(tenants=(P.TenantConfig(name="a", weight=2.0),
                                   P.TenantConfig(name="b", weight=1.0)), drr_quantum=4.0)
    q = P.RequestQueue(max_depth=256, policy=P.TenancyPolicy(cfg, clock=lambda: 0.0))
    for i in range(36):
        q.put(mk_request(P, prompt=f"a{i}", tenant="a"))
        q.put(mk_request(P, prompt=f"b{i}", tenant="b"))
    order = []
    for _ in range(24):
        pick = q.peek_best(lambda r: r.deadline)
        assert q.remove(pick)
        order.append(pick.prompt)
    assert sum(o[0] == "a" for o in order) == 16
    return order, q.tenancy_snapshot()


def drr_peek_is_idempotent_until_charged(P):
    cfg = P.GatewayConfig(tenants=(P.TenantConfig(name="a"), P.TenantConfig(name="b")))
    q = P.RequestQueue(max_depth=16, policy=P.TenancyPolicy(cfg, clock=lambda: 0.0))
    for tn in ("a", "b"):
        for i in range(3):
            q.put(mk_request(P, prompt=f"{tn}{i}", tenant=tn))
    first = q.peek_best(lambda r: r.deadline)
    for _ in range(5):
        assert q.peek_best(lambda r: r.deadline) is first
    assert q.remove(first)
    second = q.peek_best(lambda r: r.deadline)
    assert second is not first
    return first.prompt, second.prompt


def drr_starvation_freedom_under_burst(P):
    cfg = P.GatewayConfig(tenants=(P.TenantConfig(name="burst"),
                                   P.TenantConfig(name="steady")), drr_quantum=4.0)
    q = P.RequestQueue(max_depth=64, policy=P.TenancyPolicy(cfg, clock=lambda: 0.0))
    for i in range(40):
        q.put(mk_request(P, prompt=f"burst{i}", tenant="burst"))
    for i in range(5):
        q.put(mk_request(P, prompt=f"steady{i}", tenant="steady"))
    drained_at = []
    for n in range(45):
        pick = q.peek_best(lambda r: r.request_id)
        assert q.remove(pick)
        if pick.tenant == "steady":
            drained_at.append(n)
    assert len(drained_at) == 5 and drained_at[-1] <= 16
    return drained_at


def peek_urgent_sees_past_the_drr_cursor(P):
    cfg = P.GatewayConfig(tenants=(P.TenantConfig(name="burst"),
                                   P.TenantConfig(name="steady")), drr_quantum=4.0)
    q = P.RequestQueue(max_depth=64, policy=P.TenancyPolicy(cfg, clock=lambda: 0.0))
    for i in range(8):
        q.put(mk_request(P, prompt=f"burst{i}", tenant="burst", ttl=60.0))
    score = lambda r: r.deadline  # noqa: E731
    first = q.peek_best(score)
    assert first.tenant == "burst" and q.remove(first)
    q.put(mk_request(P, prompt="tight", tenant="steady", ttl=0.5))
    fair, urgent = q.peek_best(score), q.peek_urgent(score)
    assert fair.tenant == "burst"
    assert urgent.tenant == "steady" and urgent.prompt == "tight"
    assert q.remove(urgent)
    assert q.tenancy_snapshot()["steady"]["dequeued"] == 1
    assert q.peek_best(score).tenant == "burst"
    return fair.prompt, urgent.prompt, q.tenancy_snapshot()


def idle_tenant_forfeits_deficit(P):
    cfg = P.GatewayConfig(tenants=(P.TenantConfig(name="a"), P.TenantConfig(name="b")))
    pol = P.TenancyPolicy(cfg, clock=lambda: 0.0)
    q = P.RequestQueue(max_depth=16, policy=pol)
    q.put(mk_request(P, tenant="a"))
    assert q.remove(q.peek_best(lambda r: r.deadline))
    snap = pol.snapshot()
    assert snap["a"]["deficit"] == 0.0 and snap["b"]["deficit"] == 0.0
    return snap


def quota_checked_before_depth(P):
    cfg = P.GatewayConfig(tenants=(P.TenantConfig(name="t", rate_rps=0.001, burst=1.0),))
    q = P.RequestQueue(max_depth=100, policy=P.TenancyPolicy(cfg, clock=lambda: 0.0))
    q.put(mk_request(P, tenant="t"))
    with pytest.raises(P.TenantQuotaError) as info:
        q.put(mk_request(P, tenant="t"))
    assert len(q) == 1
    return str(info.value)


def event_buffer_drops_oldest_and_counts(P):
    gr = P._GatewayRequest("r", "t", max_events=4, clock=lambda: 0.0)
    drops = [gr.push("preview", {"step": i}) for i in range(10)]
    assert gr.dropped == 6
    evs, done = gr.next_events(-1, timeout=0)
    assert not done
    assert [d["step"] for _, _, d in evs] == [6, 7, 8, 9]
    assert [s for s, _, _ in evs] == [6, 7, 8, 9]
    return drops, evs


def terminal_event_never_dropped(P):
    gr = P._GatewayRequest("r", "t", max_events=2, clock=lambda: 0.0)
    for i in range(5):
        gr.push("preview", {"step": i})
    assert gr.finish("final", {"id": "r"}, outcome="completed", result={"id": "r"})
    evs, done = gr.next_events(-1, timeout=0)
    assert done and evs[-1][1] == "final"
    assert not gr.finish("cancelled", {}, outcome="cancelled")
    assert gr.outcome == "completed"
    assert gr.push("preview", {"step": 99}) == 0
    return evs, gr.status()


def push_never_blocks_on_absent_consumer(P):
    gr = P._GatewayRequest("r", "t", max_events=8, clock=lambda: 0.0)
    t0 = time.monotonic()
    for i in range(5000):
        gr.push("preview", {"step": i})
    assert time.monotonic() - t0 < 2.0
    assert gr.dropped == 5000 - 8
    return gr.dropped


def sse_wire_format(P):
    chunk = P.sse_format("preview", {"step": 1})
    assert chunk == b'event: preview\ndata: {"step": 1}\n\n'
    return chunk, P.sse_format("final", {"b": [1, 2], "a": None})


def generate_validation_errors_are_400(P):
    gw = P.Gateway(StubBackend())
    out = [gw.handle_generate(b) for b in (["not", "an", "object"], {}, {"prompt": ""},
                                           {"prompt": "p", "steps": 0},
                                           {"prompt": "p", "steps": "x"},
                                           {"prompt": "p", "deadline": -1})]
    assert all(s == 400 for s, _ in out)
    status, body = gw.handle_generate({"prompt": "p"})
    assert status == 202 and body["id"]
    return [(s, _strip(b)) for s, b in out], status, body


def unknown_id_is_404(P):
    gw = P.Gateway(StubBackend())
    assert gw.handle_status("nope")[0] == 404
    assert gw.handle_cancel("nope")[0] == 404
    with pytest.raises(KeyError):
        gw.next_events("nope")
    return gw.handle_status("nope")


def cancel_maps_to_future_cancel_exactly_one_terminal(P):
    backend = StubBackend()
    gw = P.Gateway(backend)
    _, sub = gw.handle_generate({"prompt": "p"})
    rid = sub["id"]
    _, cres = gw.handle_cancel(rid)
    assert cres["cancelled"] is True and backend.calls[0][2].cancelled()
    evs, done = gw.next_events(rid, -1, timeout=0)
    assert done and [n for _, n, _ in evs] == ["queued", "cancelled"]
    _, cres2 = gw.handle_cancel(rid)
    assert cres2["cancelled"] is False and cres2["status"] == "cancelled"
    assert len(gw.next_events(rid, -1, timeout=0)[0]) == len(evs)
    kw = dict(backend.calls[0][1])
    kw.pop("on_progress")
    return cres, cres2, evs, kw


def cancel_after_completion_loses_race(P):
    backend = StubBackend()
    gw = P.Gateway(backend)
    _, sub = gw.handle_generate({"prompt": "p"})

    class R:
        output = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
        queue_wait_s = execute_s = e2e_s = 0.0
        batch_size = 1
        compile_hit = True
        exec_key = "k"
        tier = replica = None
        previews = 0
        first_preview_s = None
        preempts = 0

    backend.calls[0][2].set_result(R())
    _, cres = gw.handle_cancel(sub["id"])
    assert cres["cancelled"] is False and cres["status"] == "completed"
    evs, done = gw.next_events(sub["id"], -1, timeout=0)
    assert done and [n for _, n, _ in evs] == ["queued", "final"]
    return cres, evs


def backend_rejection_maps_to_http_status(P):
    class Rejecting:
        def submit(self, prompt, **kw):
            raise P.QueueFullError("full")

    status, body = P.Gateway(Rejecting()).handle_generate({"prompt": "p"})
    assert status == 429 and body["error"] == "QueueFullError" and body["retryable"]
    return status, body


def stop_resolves_every_open_stream(P):
    gw = P.Gateway(StubBackend())
    rids = [gw.handle_generate({"prompt": f"p{i}"})[1]["id"] for i in range(4)]
    finished = []
    lock = P.sync.Lock()

    def reader(rid):
        cursor = -1
        while True:
            evs, resolved = gw.next_events(rid, cursor, timeout=0.1)
            for seq, _, _ in evs:
                cursor = seq
            if resolved and not evs:
                break
        with lock:
            finished.append(rid)

    threads = [P.sync.Thread(target=reader, args=(rid,)) for rid in rids]
    for t in threads:
        t.start()
    time.sleep(0.05)
    gw.stop()
    for t in threads:
        t.join(timeout=5)
        assert not t.is_alive()
    assert sorted(finished) == sorted(rids)
    status, body = gw.handle_generate({"prompt": "late"})
    assert status == 503 and body["error"] == "ServerClosedError"
    return sorted(finished), status, body


def http_generation_byte_identical_to_inprocess(P):
    cfg = serve_config(P, gateway=P.GatewayConfig(port=0, tenants=(
        P.TenantConfig(name="a", weight=2.0), P.TenantConfig(name="b", weight=1.0))))
    with P.InferenceServer(P.StepFakeExecutorFactory(batch_size=4), cfg) as srv:
        base = srv.gateway_endpoint.url
        assert base.startswith("http://127.0.0.1:")
        status, sub = post_json(base + "/v1/generate", {
            "prompt": "hello", "steps": 4, "seed": 7, "height": 64, "width": 64,
            "tenant": "a"})
        assert status == 202
        events = read_sse(base + sub["events"])
        names = [n for n, _ in events]
        assert names[0] == "queued" and names[-1] == "final"
        assert names.count("preview") >= 1
        final = events[-1][1]
        img = P.decode_image(final)
        ref = srv.submit("hello", height=64, width=64, num_inference_steps=4, seed=7,
                         tenant="a").result(timeout=30)
        assert img.tobytes() == np.asarray(ref.output).tobytes()
        assert img.dtype == np.asarray(ref.output).dtype
        previews = [d for n, d in events if n == "preview"]
        assert previews[0]["total_steps"] == 4 and P.decode_image(previews[0]).ndim == 3
        assert final["metrics"]["previews"] >= 1 and final["metrics"]["queue_wait_s"] >= 0.0
        with urllib.request.urlopen(base + sub["poll"], timeout=5) as r:
            st = json.loads(r.read())
        assert st["status"] == "completed"
        snap = srv.metrics_snapshot()
        assert snap["tenancy"]["a"]["admitted"] >= 2
    return (sub, names, img.tobytes(), [(d["step"], d["image_b64"]) for d in previews],
            final["metrics"]["exec_key"], st["status"], snap["tenancy"]["a"]["admitted"])


def http_tenant_quota_is_429(P):
    cfg = serve_config(P, gateway=P.GatewayConfig(port=0, tenants=(
        P.TenantConfig(name="t", rate_rps=0.001, burst=1.0),)))
    with P.InferenceServer(P.StepFakeExecutorFactory(batch_size=4), cfg) as srv:
        base = srv.gateway_endpoint.url
        status, sub = post_json(base + "/v1/generate", {
            "prompt": "ok", "height": 64, "width": 64, "steps": 2, "tenant": "t"})
        assert status == 202
        bodies = []
        for tenant in ("t", "stranger"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                post_json(base + "/v1/generate", {
                    "prompt": "over", "height": 64, "width": 64, "steps": 2,
                    "tenant": tenant})
            assert ei.value.code == 429
            body = json.loads(ei.value.read())
            assert body["error"] == "TenantQuotaError" and body["retryable"]
            bodies.append(body)
        events = read_sse(base + sub["events"])
        assert events[-1][0] == "final"
        assert srv.counters.get("rejected_tenant_quota") == 2
        tenancy = srv.metrics_snapshot()["tenancy"]
    # the bucket's refill depends on the wall clock between requests
    return bodies, [n for n, _ in events], _untimed(tenancy)


def http_bad_json_and_unknown_routes(P):
    with P.InferenceServer(P.StepFakeExecutorFactory(batch_size=4), serve_config(P)) as srv:
        base = srv.gateway_endpoint.url
        req = urllib.request.Request(base + "/v1/generate", data=b"{not json",
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=5)
        assert ei.value.code == 400
        bad = json.loads(ei.value.read())
        with pytest.raises(urllib.error.HTTPError) as ei2:
            urllib.request.urlopen(base + "/v1/nope", timeout=5)
        assert ei2.value.code == 404
        with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
            health = json.loads(r.read())
        assert health["scheduler_alive"]
    return bad, json.loads(ei2.value.read()), health["status"]


def http_cancel_round_trip(P):
    cfg = serve_config(P, step_batching=P.StepBatchConfig(enabled=True, slots=1,
                                                          preview_interval=1))
    factory = P.StepFakeExecutorFactory(batch_size=1, step_time_s=0.02)
    with P.InferenceServer(factory, cfg) as srv:
        base = srv.gateway_endpoint.url
        _, first = post_json(base + "/v1/generate", {
            "prompt": "long", "steps": 40, "height": 64, "width": 64})
        _, second = post_json(base + "/v1/generate", {
            "prompt": "victim", "steps": 40, "height": 64, "width": 64})
        status, cres = post_json(base + f"/v1/requests/{second['id']}/cancel", {})
        assert status == 200 and cres["cancelled"] is True
        names = [n for n, _ in read_sse(base + second["events"])]
        assert names[-1] == "cancelled" and names.count("cancelled") == 1
        events1 = read_sse(base + first["events"])
        assert events1[-1][0] == "final"
    return cres, names, P.decode_image(events1[-1][1]).tobytes()


def backpressure_drops_previews_never_stalls_scheduler(P):
    cfg = serve_config(P, gateway=P.GatewayConfig(port=0, max_events=4))
    with P.InferenceServer(P.StepFakeExecutorFactory(batch_size=4), cfg) as srv:
        base = srv.gateway_endpoint.url
        _, sub = post_json(base + "/v1/generate", {
            "prompt": "burst", "steps": 32, "height": 64, "width": 64})
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            with urllib.request.urlopen(base + sub["poll"], timeout=5) as r:
                st = json.loads(r.read())
            if st["status"] != "pending":
                break
            time.sleep(0.02)
        assert st["status"] == "completed" and st["dropped_previews"] > 0
        events = read_sse(base + sub["events"])
        assert events[-1][0] == "final"
        drops = srv.registry.snapshot()["gateway_preview_drops"][0]["data"]
        assert sum(drops.values()) == st["dropped_previews"]
    # 32 previews and the final into a buffer of 4 holding queued first
    return st["dropped_previews"], [n for n, _ in events], drops


def gateway_over_fleet_failover(P):
    plan = P.FaultPlan([P.FaultRule(site="execute", kind="execute_error", p=1.0,
                                    max_fires=1)], seed=0)
    cfg = P.ServeConfig(max_queue_depth=32, batch_window_s=0.0, buckets=((64, 64),),
                        warmup_buckets=(), default_steps=4,
                        resilience=P.ResilienceConfig(max_retries=0))
    registry, ledger = P.MetricsRegistry(), P.ExecutionLedger()
    reps = [P.Replica("heavy", P.LedgerFakeExecutorFactory(ledger, replica="heavy",
                                                           batch_size=4),
                      cfg, capacity_weight=10.0, fault_plan=plan, registry=registry),
            P.Replica("light", P.LedgerFakeExecutorFactory(ledger, replica="light",
                                                           batch_size=4),
                      cfg, capacity_weight=1.0, registry=registry)]
    fleet = P.FleetRouter(reps, P.FleetConfig(tick_s=0), registry=registry)
    with fleet:
        gw = P.Gateway(fleet, config=P.GatewayConfig(port=0)).start(port=0)
        try:
            _, sub = post_json(gw.url + "/v1/generate", {
                "prompt": "only", "seed": 7, "height": 64, "width": 64, "steps": 4})
            events = read_sse(gw.url + sub["events"])
            assert events[-1][0] == "final"
            assert events[-1][1]["metrics"]["replica"] == "light"
            assert ledger.count("only", 7) == 1
        finally:
            gw.stop()
    snap = fleet.metrics_snapshot()["fleet"]
    assert snap["requests"]["failovers"] == 1
    return ledger.snapshot(), P.decode_image(events[-1][1]).tobytes(), snap["requests"]


def http_stop_closes_open_streams(P):
    cfg = serve_config(P, step_batching=P.StepBatchConfig(enabled=True, slots=1,
                                                          preview_interval=1))
    srv = P.InferenceServer(P.StepFakeExecutorFactory(batch_size=1, step_time_s=0.005), cfg)
    srv.start()
    base = srv.gateway_endpoint.url
    _, sub = post_json(base + "/v1/generate", {
        "prompt": "long", "steps": 200, "height": 64, "width": 64})
    got = {}

    def consume():
        try:
            got["events"] = read_sse(base + sub["events"], timeout=30)
        except Exception as exc:  # noqa: BLE001 -- abrupt close is fine
            got["error"] = exc

    t = P.sync.Thread(target=consume)
    t.start()
    time.sleep(0.2)
    srv.stop()
    t.join(timeout=10)
    assert not t.is_alive()
    assert srv.gateway_endpoint is None
    return not t.is_alive()


def httpbase_immediate_rebind(P):
    import http.server

    class Ping(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", "4")
            self.end_headers()
            self.wfile.write(b"pong")

    host = P.HTTPServerHost(Ping, port=0).start()
    port = host.port
    with urllib.request.urlopen(host.url + "/", timeout=5) as r:
        first = r.read()
    host.stop()
    host2 = P.HTTPServerHost(Ping, port=port).start()
    assert host2.port == port
    with urllib.request.urlopen(host2.url + "/", timeout=5) as r:
        second = r.read()
    host2.stop()
    assert first == second == b"pong"
    return first, second


def metrics_endpoint_still_serves_after_refactor(P):
    with P.InferenceServer(P.StepFakeExecutorFactory(batch_size=4), serve_config(P)) as srv:
        ep = srv.start_metrics_endpoint(port=0)
        with urllib.request.urlopen(ep.url + "/metrics", timeout=5) as r:
            assert b"serve_" in r.read()
        with urllib.request.urlopen(ep.url + "/healthz", timeout=5) as r:
            health = json.loads(r.read())
        assert health["scheduler_alive"]
    return health["status"]


SCENARIOS = {f.__name__: f for f in (
    token_bucket_refill_and_burst, unlimited_bucket_never_rejects, tenant_config_validation,
    quota_rejection_is_typed_and_counted, drr_share_follows_weights,
    drr_peek_is_idempotent_until_charged, drr_starvation_freedom_under_burst,
    peek_urgent_sees_past_the_drr_cursor, idle_tenant_forfeits_deficit,
    quota_checked_before_depth, event_buffer_drops_oldest_and_counts,
    terminal_event_never_dropped, push_never_blocks_on_absent_consumer, sse_wire_format,
    generate_validation_errors_are_400, unknown_id_is_404,
    cancel_maps_to_future_cancel_exactly_one_terminal, cancel_after_completion_loses_race,
    backend_rejection_maps_to_http_status, stop_resolves_every_open_stream,
    http_generation_byte_identical_to_inprocess, http_tenant_quota_is_429,
    http_bad_json_and_unknown_routes, http_cancel_round_trip,
    backpressure_drops_previews_never_stalls_scheduler, gateway_over_fleet_failover,
    http_stop_closes_open_streams, httpbase_immediate_rebind,
    metrics_endpoint_still_serves_after_refactor)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_gateway_scenario_matches_jax(name):
    # the two packages' runs overlap on two threads: the scenarios wait on
    # sleeps, sockets and fakes, not on the CPU
    pkgs = [pkg(n) for n in PACKAGES]
    with ThreadPoolExecutor(2) as pool:
        want, got = [f.result() for f in [pool.submit(SCENARIOS[name], P) for P in pkgs]]
    assert got == want


def test_drr_pick_and_token_bucket_match_jax_on_a_random_workload():
    """Three weighted tenants with quotas on an injected clock, random
    arrivals, steps and deadlines: every admission verdict, every DRR pick
    and every snapshot are the JAX policy's."""
    records = []
    for name in PACKAGES:
        P = pkg(name)
        rng = np.random.RandomState(4)
        t = [0.0]
        cfg = P.GatewayConfig(tenants=(
            P.TenantConfig(name="a", weight=3.0, rate_rps=4.0, burst=3.0),
            P.TenantConfig(name="b", weight=1.0),
            P.TenantConfig(name="c", weight=2.0, rate_rps=1.0, burst=2.0)), drr_quantum=2.0)
        q = P.RequestQueue(max_depth=24, policy=P.TenancyPolicy(cfg, clock=lambda: t[0]))
        log = []
        for i in range(300):
            t[0] += float(rng.exponential(0.1))
            if rng.rand() < 0.6:
                tenant = "abcd"[rng.randint(4)]
                req = P.Request(prompt=f"{tenant}{i}", height=64, width=64,
                                num_inference_steps=int(rng.randint(1, 9)),
                                deadline=t[0] + float(rng.uniform(0.5, 5.0)), seed=i,
                                tenant=tenant, enqueue_ts=t[0])
                try:
                    q.put(req)
                    log.append(("put", req.prompt))
                except (P.TenantQuotaError, P.QueueFullError) as exc:
                    log.append(("reject", req.prompt, type(exc).__name__, str(exc)))
            elif len(q):
                pick = q.peek_best(lambda r: r.deadline)
                if rng.rand() < 0.2:
                    pick = q.peek_urgent(lambda r: r.deadline - 0.01 * r.num_inference_steps)
                assert q.remove(pick)
                log.append(("take", pick.prompt))
        log.append(("snapshot", q.tenancy_snapshot()))
        records.append(log)
    assert records[1] == records[0]
    assert any(e[0] == "reject" for e in records[0])


def test_encode_image_crosses_the_packages_byte_for_byte():
    import jax.numpy as jnp
    import ml_dtypes

    from distrifuser_tpu.serve.gateway import decode_image as jax_decode
    from distrifuser_tpu.serve.gateway import encode_image as jax_encode
    from distrifuser_tpu_torch.serve.gateway import decode_image, encode_image

    rng = np.random.RandomState(0)
    for arr in (rng.rand(8, 6, 3).astype(np.float32),
                (rng.rand(4, 4, 3) * 255).astype(np.uint8),
                rng.randn(5, 2).astype(np.float64)):
        assert encode_image(arr) == jax_encode(arr)
        assert encode_image(torch.from_numpy(arr)) == jax_encode(arr)
        for enc, dec in ((encode_image, jax_decode), (jax_encode, decode_image)):
            back = dec(enc(arr))
            assert back.dtype == arr.dtype and back.tobytes() == arr.tobytes()
    # bfloat16: a torch tensor's raw words against a JAX array's
    base = rng.randn(6, 4, 3).astype(np.float32)
    tb = torch.from_numpy(base).to(torch.bfloat16)
    jb = jnp.asarray(base, dtype=jnp.bfloat16)
    ours, theirs = encode_image(tb), jax_encode(jb)
    assert ours == theirs and ours["dtype"] == "bfloat16"
    j_back = jax_decode(ours)
    assert j_back.dtype == ml_dtypes.bfloat16 and j_back.tobytes() == np.asarray(jb).tobytes()
    p_back = decode_image(theirs)
    assert p_back.dtype == torch.bfloat16 and torch.equal(p_back, tb)
    assert p_back.float().numpy().tobytes() == np.asarray(jb, np.float32).tobytes()


# -- the tiny SDXL pipeline through the wire -----------------------------------


from test_torch_port_serve_pipeline import (  # noqa: E402
    SDXL_TOL, _jax_sdxl, _port_sdxl, sdxl_trees)  # noqa: F401 -- fixture

STEPS = 3
WIRE = [("a lighthouse at dusk", 31), ("a corgi on a skateboard", 32)]


def _wire_server(P, factory):
    cfg = P.ServeConfig(
        buckets=((128, 128),), max_batch_size=2, batch_window_s=0.001, default_steps=STEPS,
        warmup_buckets=(), max_queue_depth=16, default_ttl_s=600.0,
        step_batching=P.StepBatchConfig(enabled=True, slots=2, preview_interval=1),
        gateway=P.GatewayConfig(port=0, host="127.0.0.1", tenants=(
            P.TenantConfig(name="a", weight=2.0), P.TenantConfig(name="b", weight=1.0))))
    return P.InferenceServer(factory, cfg, model_id="tiny-sdxl")


def _through_wire(srv, prompt, seed, tenant):
    base = srv.gateway_endpoint.url
    status, sub = post_json(base + "/v1/generate", {
        "prompt": prompt, "seed": seed, "steps": STEPS, "height": 128, "width": 128,
        "tenant": tenant})
    assert status == 202
    events = read_sse(base + sub["events"], timeout=300)
    names = [n for n, _ in events]
    assert names[0] == "queued" and names[-1] == "final"
    assert names.count("preview") == STEPS
    return events[-1][1]


def test_wire_image_equals_inprocess_and_solo_and_matches_jax(devices8, sdxl_trees):
    from distrifuser_tpu.serve.executors import pipeline_executor_factory as jax_factory
    from distrifuser_tpu_torch.serve import pipeline_executor_factory

    T, J = pkg(PACKAGES[1]), pkg(PACKAGES[0])
    pipes = []

    def port_build(key):
        pipes.append(_port_sdxl(sdxl_trees))
        return pipes[-1]

    with _wire_server(T, pipeline_executor_factory(port_build)) as srv:
        for (prompt, seed), tenant in zip(WIRE, ("a", "b")):
            final = _through_wire(srv, prompt, seed, tenant)
            wire = T.decode_image(final)
            ref = srv.submit(prompt, height=128, width=128, num_inference_steps=STEPS,
                             seed=seed, tenant=tenant).result(timeout=300)
            assert wire.dtype == np.float32 and wire.shape == (32, 32, 3)
            assert wire.tobytes() == np.asarray(ref.output).tobytes()
            solo = pipes[0](prompt, seed=seed, num_inference_steps=STEPS,
                            output_type="np").images[0]
            np.testing.assert_array_equal(wire, solo)
        tenancy = srv.metrics_snapshot()["tenancy"]
    assert tenancy["a"]["admitted"] == 2 and tenancy["b"]["admitted"] == 2

    # the JAX package behind its gateway, fed initial latents of its own,
    # against the port's solo calls from the same latents
    sigma = float(pipes[0].scheduler.init_noise_sigma)
    lat = {s: np.random.RandomState(s).randn(1, 16, 16, 4).astype(np.float32) * sigma
           for _, s in WIRE}
    want = np.stack([pipes[0](p, latents=torch.from_numpy(lat[s]), num_inference_steps=STEPS,
                              output_type="np").images[0] for p, s in WIRE])

    def jax_fixed(key, _inner=jax_factory(lambda k: _jax_sdxl(devices8, sdxl_trees))):
        ex = _inner(key)
        ex._draw_latents = lambda seeds: np.concatenate([lat[s] for s in seeds])
        return ex

    with _wire_server(J, jax_fixed) as srv:
        got = np.stack([J.decode_image(_through_wire(srv, p, s, "a")) for p, s in WIRE])
    np.testing.assert_allclose(got, want, rtol=0, atol=SDXL_TOL)
