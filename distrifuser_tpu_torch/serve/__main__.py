"""CPU-only serve demo: ``python -m distrifuser_tpu_torch.serve --demo``.

Drives the REAL scheduler (queue, batcher, bucket table, compiled-executable
cache, metrics) with the weightless fake executor, and self-checks the
serving invariants the subsystem exists for:

1. concurrent requests coalesce (some batched invocation has >= 2 requests);
2. after warmup the compiled cache only misses on first use of each bucket
   (hit rate > 0, misses == distinct buckets touched);
3. the per-request latency/queue metrics JSON artifact is emitted.

Exit code 0 only if all three hold — the demo doubles as an end-to-end
smoke test on any box, no weights or accelerator required.

``--gateway-port N`` (with ``--demo``) switches to the gateway demo:
a step-batching server (progressive previews every step) fronted by the
HTTP/SSE gateway on port N (0 = ephemeral), requests driven THROUGH the
wire, with ``--tenants`` taking the tenant table as inline JSON, e.g.::

    python -m distrifuser_tpu_torch.serve --demo --gateway-port 8977 \\
        --tenants '{"bulk": {"weight": 1, "rate_rps": 2, "burst": 4},
                    "interactive": {"weight": 4}}'

Combine with ``--hold-s`` to keep the gateway live for external curl
probes.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..utils import sync
from ..utils.config import (
    GatewayConfig,
    ObservabilityConfig,
    ServeConfig,
    StepBatchConfig,
    TenantConfig,
)
from .server import InferenceServer
from .testing import FakeExecutorFactory, StepFakeExecutorFactory


def run_demo(metrics_path: str = None, verbose: bool = True,
             metrics_port: int = None, hold_s: float = 0.0,
             trace_out: str = None, dump_dir: str = None) -> int:
    config = ServeConfig(
        max_queue_depth=32,
        max_batch_size=4,
        batch_window_s=0.15,
        buckets=((512, 512), (1024, 1024)),
        warmup_buckets=((512, 512, 4),),
        default_steps=4,
        cache_capacity=4,
        observability=ObservabilityConfig(
            trace=bool(trace_out or dump_dir),
            metrics_port=metrics_port,
        ),
    )
    factory = FakeExecutorFactory(
        batch_size=4, build_delay_s=0.2, step_time_s=0.02
    )
    say = print if verbose else (lambda *a, **k: None)
    server = InferenceServer(
        factory, config, model_id="demo-sdxl", scheduler="ddim",
        mesh_plan="dp1.cfg2.sp4",
    )
    say("starting server (warmup compiles the 512x512 bucket)...")
    with server:
        if server.metrics_endpoint is not None:
            say(f"metrics endpoint: {server.metrics_endpoint.url}/metrics "
                f"(+ /metrics.json, /healthz)")
        # two waves of concurrent submissions: wave 1 lands in the warmed
        # 512 bucket; wave 2 mixes in 768x640 requests that snap to the
        # 1024x1024 bucket (its first use = the only other compile)
        futures = []
        lock = sync.Lock()

        def client(prompt, h, w, seed):
            f = server.submit(prompt, height=h, width=w, seed=seed)
            with lock:
                futures.append((prompt, h, w, f))

        waves = [
            [(f"a photo of a corgi #{i}", 512, 512, i) for i in range(4)],
            [(f"a watercolor skyline #{i}", 768, 640, 10 + i)
             for i in range(3)]
            + [(f"a photo of a corgi #{i}", 512, 512, 20 + i)
               for i in range(2)],
        ]
        for wave in waves:
            threads = [sync.Thread(target=client, args=a) for a in wave]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            # let the wave coalesce and finish before the next arrives
            for _, _, _, f in list(futures):
                f.result(timeout=30)

        say(f"\n{'request':34s} {'bucket':>11s} {'batch':>5s} "
            f"{'hit':>4s} {'wait_ms':>8s} {'e2e_ms':>7s}")
        for prompt, h, w, f in futures:
            r = f.result(timeout=30)
            say(f"{prompt:34s} {r.bucket[0]:4d}x{r.bucket[1]:<4d} "
                f"{r.batch_size:5d} {str(r.compile_hit):>4s} "
                f"{r.queue_wait_s * 1e3:8.1f} {r.e2e_s * 1e3:7.1f}")

        snap = server.metrics_snapshot()
        health = server.health()
        if metrics_path:
            server.export_metrics(metrics_path)
            say(f"\nmetrics JSON written to {metrics_path}")
        if trace_out:
            server.tracer.export(trace_out)
            say(f"Perfetto trace written to {trace_out} "
                "(load at https://ui.perfetto.dev)")
        if dump_dir:
            paths = server.dump_observability(dump_dir)
            say(f"observability dump: {', '.join(sorted(paths))}")
        if hold_s > 0:
            # keep serving /metrics after the demo work finishes so an
            # external scraper (a curl probe) can reach a live server
            say(f"holding {hold_s:.0f}s for metrics scrapes...")
            import time

            time.sleep(hold_s)
    say("\nmetrics snapshot:")
    say(json.dumps(snap, indent=2, sort_keys=True))
    say("\nhealth snapshot (as served while running):")
    say(json.dumps(health, indent=2, sort_keys=True))

    # -- self-checks (the acceptance criteria of the subsystem) -----------
    batch_sizes = factory.batch_sizes()
    coalesced = max(batch_sizes, default=0) >= 2
    cache = snap["cache"]
    distinct_buckets = len(set(factory.built))
    warm_only_first_use = cache["misses"] == distinct_buckets
    checks = {
        "coalesced (some batch >= 2 requests)": coalesced,
        "cache hit rate > 0 after warmup": cache["hits"] > 0,
        "cache misses only on first bucket use": warm_only_first_use,
        "all requests completed": snap["requests"].get("completed", 0)
        == len(futures),
        "health: scheduler alive, no open circuits, no degradations":
        health["scheduler_alive"] and health["status"] == "ok",
    }
    say("")
    ok = True
    for name, passed in checks.items():
        say(f"  [{'ok' if passed else 'FAIL'}] {name}")
        ok = ok and passed
    return 0 if ok else 1


def parse_tenants(spec: str):
    """``--tenants`` inline JSON table -> tuple of TenantConfig.

    ``{"name": {"weight": w, "rate_rps": r, "burst": b}, ...}`` — every
    knob optional (weight 1, unlimited rate by default).
    """
    table = json.loads(spec)
    if not isinstance(table, dict):
        raise ValueError("--tenants must be a JSON object keyed by "
                         "tenant name")
    tenants = []
    for name, knobs in table.items():
        knobs = knobs or {}
        if not isinstance(knobs, dict):
            raise ValueError(f"tenant {name!r}: knobs must be an object")
        unknown = set(knobs) - {"weight", "rate_rps", "burst"}
        if unknown:
            raise ValueError(f"tenant {name!r}: unknown knobs {unknown}")
        tenants.append(TenantConfig(
            name=name,
            weight=float(knobs.get("weight", 1.0)),
            rate_rps=float(knobs.get("rate_rps", 0.0)),
            burst=float(knobs.get("burst", 0.0)),
        ))
    return tuple(tenants)


def run_gateway_demo(gateway_port: int, tenants_spec: str = None,
                     metrics_path: str = None, verbose: bool = True,
                     metrics_port: int = None, hold_s: float = 0.0,
                     trace_out: str = None) -> int:
    """Gateway demo: step-batching server behind the HTTP/SSE gateway,
    every request driven through the wire."""
    import urllib.error
    import urllib.request

    from .gateway import decode_image

    say = print if verbose else (lambda *a, **k: None)
    tenants = parse_tenants(tenants_spec) if tenants_spec else (
        TenantConfig(name="interactive", weight=4.0),
        TenantConfig(name="bulk", weight=1.0, rate_rps=50.0, burst=16.0),
    )
    config = ServeConfig(
        max_queue_depth=64,
        batch_window_s=0.01,
        buckets=((64, 64),),
        default_steps=6,
        step_batching=StepBatchConfig(enabled=True, slots=4,
                                      preview_interval=1),
        gateway=GatewayConfig(port=gateway_port, tenants=tenants),
        observability=ObservabilityConfig(
            trace=bool(trace_out), metrics_port=metrics_port,
        ),
    )
    factory = StepFakeExecutorFactory(batch_size=4, step_time_s=0.01)
    server = InferenceServer(factory, config, model_id="demo-sdxl",
                             scheduler="ddim", mesh_plan="dp1.cfg1.sp1")
    say("starting step-batching server behind the gateway...")
    with server:
        gw = server.gateway_endpoint
        say(f"gateway: {gw.url}/v1/generate "
            f"(tenants: {', '.join(t.name for t in tenants)})")
        if server.metrics_endpoint is not None:
            say(f"metrics endpoint: {server.metrics_endpoint.url}/metrics")

        def post(path, body):
            req = urllib.request.Request(
                gw.url + path, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=15) as r:
                return json.loads(r.read())

        # one streamed request per tenant, through the wire
        finals = {}
        for i, t in enumerate(tenants):
            sub = post("/v1/generate", {
                "prompt": f"a photo of a corgi #{i}", "steps": 6,
                "seed": i, "height": 64, "width": 64, "tenant": t.name,
            })
            names = []
            with urllib.request.urlopen(gw.url + sub["events"],
                                        timeout=30) as r:
                name = None
                for line in r:
                    line = line.decode().rstrip("\n")
                    if line.startswith("event: "):
                        name = line[7:]
                    elif line.startswith("data: "):
                        names.append(name)
                        if name == "final":
                            finals[t.name] = json.loads(line[6:])
            say(f"  {t.name:14s} -> {sub['id']}: {', '.join(names)}")
        # cancel path: submit then immediately cancel
        sub = post("/v1/generate", {"prompt": "cancel me", "steps": 6,
                                    "height": 64, "width": 64})
        cres = post(f"/v1/requests/{sub['id']}/cancel", {})
        say(f"  cancel {sub['id']}: cancelled={cres['cancelled']}")

        snap = server.metrics_snapshot()
        if metrics_path:
            server.export_metrics(metrics_path)
            say(f"metrics JSON written to {metrics_path}")
        if trace_out:
            server.tracer.export(trace_out)
            say(f"Perfetto trace written to {trace_out}")
        if hold_s > 0:
            say(f"holding {hold_s:.0f}s for external gateway probes...")
            import time

            time.sleep(hold_s)
    decoded = {n: decode_image(p).shape for n, p in finals.items()}
    previews = {n: p["metrics"]["previews"] for n, p in finals.items()}
    checks = {
        "every tenant's stream reached final": len(finals) == len(tenants),
        "progressive previews streamed (>0 each)": all(
            v > 0 for v in previews.values()) and bool(previews),
        "final images decode to arrays": all(
            len(s) == 3 for s in decoded.values()),
        "tenancy accounting present": snap.get("tenancy") is not None,
    }
    say("")
    ok = True
    for name, passed in checks.items():
        say(f"  [{'ok' if passed else 'FAIL'}] {name}")
        ok = ok and passed
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distrifuser_tpu_torch.serve",
        description="serve-subsystem demo (fake executors, CPU-only)",
    )
    ap.add_argument("--demo", action="store_true",
                    help="run the end-to-end scheduler demo")
    ap.add_argument("--metrics-path", type=str, default=None,
                    help="also write the metrics JSON artifact here")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics (Prometheus), /metrics.json and "
                         "/healthz on this port while the demo runs "
                         "(0 = ephemeral)")
    ap.add_argument("--hold-s", type=float, default=0.0,
                    help="keep the server (and its metrics endpoint) "
                         "alive this long after the demo work finishes, "
                         "so external scrapers can probe it")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="enable request-scoped tracing and write the "
                         "Perfetto-loadable trace JSON here")
    ap.add_argument("--dump-dir", type=str, default=None,
                    help="write the full observability dump (metrics/"
                         "registry/health/slo/trace) into this directory")
    ap.add_argument("--gateway-port", type=int, default=None,
                    help="run the gateway demo instead: step-batching "
                         "server behind the HTTP/SSE gateway on this port "
                         "(0 = ephemeral)")
    ap.add_argument("--tenants", type=str, default=None,
                    help="inline JSON tenant table for the gateway demo, "
                         "e.g. '{\"bulk\": {\"weight\": 1, \"rate_rps\": 2"
                         ", \"burst\": 4}, \"interactive\": {\"weight\": 4"
                         "}}'")
    args = ap.parse_args(argv)
    if not args.demo:
        ap.error("nothing to do: pass --demo (real serving is wired "
                 "through distrifuser_tpu_torch.serve.InferenceServer + "
                 "pipeline_executor_factory)")
    if args.gateway_port is not None:
        return run_gateway_demo(
            gateway_port=args.gateway_port, tenants_spec=args.tenants,
            metrics_path=args.metrics_path, metrics_port=args.metrics_port,
            hold_s=args.hold_s, trace_out=args.trace_out)
    return run_demo(metrics_path=args.metrics_path,
                    metrics_port=args.metrics_port, hold_s=args.hold_s,
                    trace_out=args.trace_out, dump_dir=args.dump_dir)


if __name__ == "__main__":
    sys.exit(main())
