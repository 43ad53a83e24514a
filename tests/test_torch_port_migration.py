"""PyTorch port: carry migration (serve/migration.py, ROADMAP item 16c)
against the JAX package's.

* The envelope is byte-compatible: the same carry encodes to the same
  bytes in both packages, a JAX snapshot decodes in the port and a port
  snapshot in the JAX package, leaves byte-equal and header fields equal
  -- bfloat16 leaves included (raw two bytes an element under the
  ``"bfloat16"`` descriptor; the port reads them into a torch.bfloat16
  tensor).
* Every rejection of tests/test_migration.py raises `MigrationRejectedError`
  with the same message in both packages: truncation, corruption, bad
  magic, version skew, a malformed header, descriptor drift, trailing
  bytes, identity and ExecKey mismatches.
* The server scenarios on the step fakes run once per package with equal
  records: a carry exported at stop resumes on a fresh server bit-identically
  (three families), identity and key mismatches fail typed, import needs
  step batching, ``export_carries`` off and a failing export.  A carry a
  JAX server exported finishes on a port server, and the other way round.
"""

import dataclasses
import hashlib
import importlib
import json
import struct
import time

import ml_dtypes
import numpy as np
import pytest
import torch

PACKAGES = ("distrifuser_tpu", "distrifuser_tpu_torch")


class Pkg:
    def __init__(self, name):
        self.serve = importlib.import_module(f"{name}.serve")
        self.testing = importlib.import_module(f"{name}.serve.testing")
        self.migration = importlib.import_module(f"{name}.serve.migration")


def key_for(P, model="m", steps=4, **kw):
    return P.serve.ExecKey(model_id=model, scheduler="ddim", height=64, width=64,
                           steps=steps, cfg=True, mesh_plan="dp1.cfg1.sp1",
                           exec_mode="step", **kw)


def serve_config(P, **kw):
    kw.setdefault("max_queue_depth", 32)
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("batch_window_s", 0.001)
    kw.setdefault("buckets", ((64, 64),))
    kw.setdefault("warmup_buckets", ())
    kw.setdefault("default_steps", 4)
    kw.setdefault("default_ttl_s", 60.0)
    kw.setdefault("step_batching", P.serve.StepBatchConfig(enabled=True, slots=4))
    return P.serve.ServeConfig(**kw)


def mk_envelope(P, *, step=2, steps_total=6, prompt="a cat", seed=7, leaves=None,
                extra=None, ekey=None):
    if leaves is None:
        leaves = [np.arange(12, dtype=np.float32).reshape(3, 4),
                  np.asarray([step], dtype=np.int32)]
    return P.migration.encode_snapshot(
        ekey=ekey or key_for(P, steps=steps_total), family="StepFakeExecutor",
        step=step, steps_total=steps_total, request_id="rq-1", prompt=prompt,
        seed=seed, leaves=leaves, extra=extra)


def tamper_header(P, data, fn):
    magic = P.migration.MAGIC
    payload = data[:-32]
    (hlen,) = struct.unpack_from(">I", payload, len(magic))
    off = len(magic) + 4
    meta = fn(json.loads(payload[off:off + hlen])) or {}
    header = json.dumps(meta, sort_keys=True).encode("utf-8")
    body = magic + struct.pack(">I", len(header)) + header + payload[off + hlen:]
    return body + hashlib.sha256(body).digest()


def wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.002)


def _host(leaf):
    return (leaf.view(torch.int16).numpy() if isinstance(leaf, torch.Tensor)
            and leaf.dtype == torch.bfloat16 else np.asarray(leaf))


# -- the envelope --------------------------------------------------------------


def test_envelope_is_byte_compatible_with_jax():
    J, T = Pkg(PACKAGES[0]), Pkg(PACKAGES[1])
    rs = np.random.RandomState(0)
    bf = rs.randn(2, 3, 5).astype(ml_dtypes.bfloat16)
    leaves = [rs.randn(2, 4, 4).astype(np.float32), bf, np.asarray([3.5], np.float32),
              np.asarray([[True, False]]), np.asarray([3], np.int32)]
    kw = dict(step=3, steps_total=8, extra={"note": "x"})
    jdata = mk_envelope(J, leaves=leaves, **kw)
    # numpy leaves encode to the JAX package's bytes, 0-dim ones included
    # (numpy's ascontiguousarray writes them as shape [1] in both)
    zero = [np.asarray(3.5, np.float32)]
    assert mk_envelope(T, leaves=zero, **kw) == mk_envelope(J, leaves=zero, **kw)
    # a 0-dim tensor (DPM++ 2M's lambda_prev) keeps its shape in the port
    (scalar,) = T.migration.decode_snapshot(
        mk_envelope(T, leaves=[torch.tensor(3.5)], **kw)).leaves
    assert scalar.shape == () and scalar.item() == 3.5
    # the port encodes torch tensors (bf16 included) to the same bytes
    tleaves = [torch.from_numpy(l.view(np.int16)).view(torch.bfloat16) if l.dtype == bf.dtype
               else torch.from_numpy(np.array(l)) for l in leaves]
    pdata = mk_envelope(T, leaves=tleaves, **kw)
    assert pdata == jdata
    psnap = T.migration.decode_snapshot(jdata)
    jsnap = J.migration.decode_snapshot(pdata)
    assert psnap.meta == jsnap.meta
    assert psnap.step == 3 and psnap.family == "StepFakeExecutor"
    assert psnap.exec_key == dataclasses.asdict(key_for(T, steps=8))
    assert psnap.leaves[1].dtype == torch.bfloat16
    for got, want in zip(psnap.leaves, jsnap.leaves):
        assert tuple(got.shape) == want.shape
        assert _host(got).tobytes() == np.asarray(want).tobytes()
    # a bf16 leaf round-trips through the port bit for bit
    again = T.migration.decode_snapshot(mk_envelope(T, leaves=list(psnap.leaves), **kw))
    assert torch.equal(again.leaves[1].view(torch.int16), psnap.leaves[1].view(torch.int16))


def _rejections(P):
    """Every envelope rejection: (what, message) pairs."""
    M = P.migration
    data = mk_envelope(P)
    out = []

    def rejects(what, blob, match):
        with pytest.raises(P.serve.MigrationRejectedError, match=match) as info:
            M.decode_snapshot(blob)
        out.append((what, str(info.value)))

    rejects("floor", data[:20], "truncated")
    rejects("digest", data[:-10], "checksum")
    for pos in (2, len(M.MAGIC) + 6, len(data) // 2):
        corrupt = bytearray(data)
        corrupt[pos] ^= 0xFF
        rejects(f"flip{pos}", bytes(corrupt), "checksum")
    body = b"NOPE" + data[len(M.MAGIC):-32]
    rejects("magic", body + hashlib.sha256(body).digest(), "magic")
    rejects("non-bytes", {"not": "bytes"}, "bytes")
    rejects("version", tamper_header(P, data, lambda m: {**m, "format": 99}), "version 99")
    payload = data[:-32]
    (hlen,) = struct.unpack_from(">I", payload, len(M.MAGIC))
    off = len(M.MAGIC) + 4
    body = payload[:off] + b"{" * hlen + payload[off + hlen:]
    with pytest.raises(P.serve.MigrationRejectedError, match="JSON"):
        M.decode_snapshot(body + hashlib.sha256(body).digest())

    def drop_seed(meta):
        del meta["seed"]
        return meta

    def nbytes(meta):
        meta["leaves"][0]["nbytes"] += 4
        return meta

    def dtype(meta):
        meta["leaves"][0]["dtype"] = "not-a-dtype"
        return meta

    def grow(meta):
        meta["leaves"][0]["shape"], meta["leaves"][0]["nbytes"] = [30, 4], 480
        return meta

    rejects("missing", tamper_header(P, data, drop_seed), "missing field")
    rejects("nbytes", tamper_header(P, data, nbytes), "inconsistent")
    rejects("dtype", tamper_header(P, data, dtype), "malformed")
    rejects("grow", tamper_header(P, data, grow), "truncated inside")
    body = data[:-32] + b"\x00\x00"
    rejects("trailing", body + hashlib.sha256(body).digest(), "trailing")
    snap = M.decode_snapshot(mk_envelope(P, steps_total=6))
    M.check_identity(snap, prompt="a cat", seed=7)
    M.check_key_compatible(snap, key_for(P, steps=6))
    for what, call, match in (
            ("seed", lambda: M.check_identity(snap, prompt="a cat", seed=8), "seed"),
            ("prompt", lambda: M.check_identity(snap, prompt="a dog", seed=7), "prompt"),
            ("steps", lambda: M.check_key_compatible(snap, key_for(P, steps=8)), "steps"),
            ("rung", lambda: M.check_key_compatible(
                snap, key_for(P, steps=6, comm_compress="int8")), "comm_compress")):
        with pytest.raises(P.serve.MigrationRejectedError, match=match) as info:
            call()
        out.append((what, str(info.value)))
    return out


def test_rejections_match_jax():
    want, got = _rejections(Pkg(PACKAGES[0])), _rejections(Pkg(PACKAGES[1]))
    assert [w for w, _ in got] == [w for w, _ in want]
    for (what, g), (_, w) in zip(got, want):
        # the port's message names a server where the JAX one names a
        # replica, and writes its dashes in ASCII
        assert g == w.replace("replica", "server").replace("\u2014", "--"), what


# -- the server scenarios on the step fakes ------------------------------------


def exported_carry_resumes(P):
    out = []
    for model in ("unet", "dit", "mmdit"):
        steps = 40
        fac_a = P.testing.StepFakeExecutorFactory(batch_size=4, step_time_s=0.005)
        server_a = P.serve.InferenceServer(fac_a, serve_config(P), model_id=model)
        server_a.start(warmup=False)
        fut = server_a.submit("a cat", height=64, width=64, seed=7, num_inference_steps=steps)
        wait_for(lambda: any(s.steps_done >= 2 for s in server_a.stepbatch.occupied()))
        server_a.stop(timeout=30.0)
        with pytest.raises(P.serve.CarryExportedError) as ei:
            fut.result(timeout=5)
        exc = ei.value
        snap = P.migration.decode_snapshot(exc.snapshot)
        assert snap.step == exc.steps_done and 0 < snap.step < steps
        assert server_a.metrics_snapshot()["requests"]["carries_exported"] == 1
        fac_b = P.testing.StepFakeExecutorFactory(batch_size=4)
        with P.serve.InferenceServer(fac_b, serve_config(P), model_id=model) as server_b:
            r = server_b.submit("a cat", height=64, width=64, seed=7, num_inference_steps=steps,
                                carry_snapshot=exc.snapshot).result(timeout=30)
        assert r.migrations == 1 and r.steps_salvaged == snap.step
        reqs = server_b.metrics_snapshot()["requests"]
        assert reqs["carries_imported"] == 1 and reqs["steps_salvaged"] == snap.step
        np.testing.assert_array_equal(
            r.output, P.testing.fake_image("a cat", 7, key_for(P, model=model, steps=steps)))
        out.append((np.asarray(r.output).tobytes(), sorted(snap.meta)))
    return out


def import_mismatches_and_refusals(P):
    data = mk_envelope(P, step=2, steps_total=4)
    fac = P.testing.StepFakeExecutorFactory(batch_size=4)
    with P.serve.InferenceServer(fac, serve_config(P)) as server:
        with pytest.raises(P.serve.MigrationRejectedError, match="seed"):
            server.submit("a cat", height=64, width=64, seed=999, carry_snapshot=data)
        corrupt = bytearray(data)
        corrupt[len(corrupt) // 2] ^= 0xFF
        with pytest.raises(P.serve.MigrationRejectedError, match="checksum"):
            server.submit("a cat", height=64, width=64, seed=7, carry_snapshot=bytes(corrupt))
        # identity passes at submit, the key gate fails the future at admission
        keyed = mk_envelope(P, step=2, steps_total=6, ekey=key_for(P, model="model", steps=6))
        fut = server.submit("a cat", height=64, width=64, seed=7, num_inference_steps=8,
                            carry_snapshot=keyed)
        with pytest.raises(P.serve.MigrationRejectedError, match="steps"):
            fut.result(timeout=30)
    reqs = server.metrics_snapshot()["requests"]
    assert reqs["migrations_rejected"] == 3 and reqs.get("carries_imported", 0) == 0
    whole = P.serve.InferenceServer(
        P.testing.FakeExecutorFactory(),
        serve_config(P, step_batching=P.serve.StepBatchConfig())).start(warmup=False)
    try:
        with pytest.raises(P.serve.MigrationRejectedError, match="step-level"):
            whole.submit("a cat", height=64, width=64, seed=7, carry_snapshot=data)
    finally:
        whole.stop(timeout=10.0)
    return reqs["migrations_rejected"]


def export_off_and_export_failure(P):
    fac = P.testing.StepFakeExecutorFactory(batch_size=4, step_time_s=0.005)
    cfg = serve_config(P, step_batching=P.serve.StepBatchConfig(enabled=True, slots=4,
                                                                export_carries=False))
    server = P.serve.InferenceServer(fac, cfg).start(warmup=False)
    fut = server.submit("p", height=64, width=64, seed=1, num_inference_steps=40)
    wait_for(lambda: any(s.steps_done >= 1 for s in server.stepbatch.occupied()))
    server.stop(timeout=30.0)
    with pytest.raises(P.serve.ServerClosedError) as ei:
        fut.result(timeout=5)
    assert not isinstance(ei.value, P.serve.CarryExportedError)

    class BoomExportFactory(P.testing.StepFakeExecutorFactory):
        def _new_executor(self, key):
            ex = super()._new_executor(key)
            ex.step_export = lambda w: (_ for _ in ()).throw(RuntimeError("injected"))
            return ex

    server = P.serve.InferenceServer(BoomExportFactory(batch_size=4, step_time_s=0.005),
                                     serve_config(P)).start(warmup=False)
    fut = server.submit("p", height=64, width=64, seed=1, num_inference_steps=40)
    wait_for(lambda: any(s.steps_done >= 1 for s in server.stepbatch.occupied()))
    server.stop(timeout=30.0)
    with pytest.raises(P.serve.CarryExportedError) as ei:
        fut.result(timeout=5)
    assert ei.value.snapshot is None and ei.value.steps_done >= 1
    reqs = server.metrics_snapshot()["requests"]
    assert reqs["carry_export_failed"] == 1 and reqs.get("carries_exported", 0) == 0
    return type(ei.value).__name__


SCENARIOS = {f.__name__: f for f in (exported_carry_resumes, import_mismatches_and_refusals,
                                     export_off_and_export_failure)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_migration_scenario_matches_jax(name):
    want = SCENARIOS[name](Pkg(PACKAGES[0]))
    got = SCENARIOS[name](Pkg(PACKAGES[1]))
    assert got == want


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_carry_migrates_across_packages(direction):
    """A carry exported by one package's server at stop finishes on the
    other package's server, equal to an unmigrated run."""
    src, dst = ((Pkg(PACKAGES[0]), Pkg(PACKAGES[1])) if direction == "jax_to_port"
                else (Pkg(PACKAGES[1]), Pkg(PACKAGES[0])))
    steps = 40
    server_a = src.serve.InferenceServer(
        src.testing.StepFakeExecutorFactory(batch_size=4, step_time_s=0.005),
        serve_config(src), model_id="m").start(warmup=False)
    fut = server_a.submit("a cat", height=64, width=64, seed=7, num_inference_steps=steps)
    wait_for(lambda: any(s.steps_done >= 2 for s in server_a.stepbatch.occupied()))
    server_a.stop(timeout=30.0)
    with pytest.raises(src.serve.CarryExportedError) as ei:
        fut.result(timeout=5)
    with dst.serve.InferenceServer(dst.testing.StepFakeExecutorFactory(batch_size=4),
                                   serve_config(dst), model_id="m") as server_b:
        r = server_b.submit("a cat", height=64, width=64, seed=7, num_inference_steps=steps,
                            carry_snapshot=ei.value.snapshot).result(timeout=30)
    assert r.migrations == 1 and r.steps_salvaged == ei.value.steps_done
    np.testing.assert_array_equal(
        r.output, dst.testing.fake_image("a cat", 7, key_for(dst, steps=steps)))
