"""PyTorch port: the refresh codec (ops/quantize.py's fused encode and
decode entries) on the CPU, where they run their plain versions.

* The fused entries equal the unfused composition the patch context ran
  before them (``x.float() - base.float()``, ``take_every_kth``,
  ``quantize``; ``dequantize``, the residual add, ``scatter_every_kth``,
  ``torch.stack``) bit for bit: payload bytes, scales and output buffers,
  for int8, fp8 and int8_residual, k in {1, 2, 4} with the rotation as an
  int and as a 0-d tensor, groups 1 and 2 in the unfused composition (the
  fused entries select the same rows on the flattened layout), float32 and
  bfloat16 sources,
  halo slabs read in place from a [B, h, W, C] activation, and a row of
  zeros.
* The grouped entries equal the per-segment ones, into a flat buffer of
  payloads then scales as the context lays them out.
* The JAX package's quantize, dequantize, take_every_kth and
  scatter_every_kth on the same numpy inputs give the same payloads, and
  scales and buffers within 1e-6 of their largest value (XLA folds the
  division by 127 or 448 into a multiplication; ROADMAP queue 3).  Each
  mode's JAX composition is jitted once, over every k and groups case.
* A compressed stale step of the context (under stand-in collectives: the
  peer's payload is this rank's own) calls the encode entry once per
  payload and the decode entry once per payload, or once each per flush
  under ``batch_comm``, and its next buffers equal the unfused
  composition's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distrifuser_tpu.parallel import compress as jax_compress
from distrifuser_tpu_torch.ops import quantize as qz
from distrifuser_tpu_torch.parallel import collectives
from distrifuser_tpu_torch.parallel import context as ctx_mod
from distrifuser_tpu_torch.parallel.compress import (dequantize, payload_mode, quantize,
                                                     scatter_every_kth, take_every_kth)

MODES = ["int8", "fp8", "int8_residual"]
KS = [1, 2, 4]
JAX_TOL = 1e-6
N, B, L, C = 2, 2, 16, 8  # ranks, batch, rows a rank, columns (KV)


def _bytes(t):
    return t.contiguous().view(torch.uint8) if t.dtype != torch.uint8 else t


def _rows(seed, shape, dtype):
    """Seeded rows with one all-zero row, in ``dtype``."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))
    x.view(-1, shape[-1])[min(3, x.numel() // shape[-1] - 1)] = 0.0
    return x.to(dtype)


def _every(k, r, as_tensor):
    if k == 1:
        return None
    return k, (torch.tensor(r) if as_tensor else r)


# -- the unfused composition the context ran before the codec --------------


def _old_encode(src, base, every, groups, mode):
    """Payload and scales of ``src`` rows (minus ``base``) as
    parallel/context.py computed them: take, float, subtract, quantize."""
    if every is not None:
        src = take_every_kth(src, every[0], every[1], groups=groups)
        base = None if base is None else take_every_kth(base, every[0], every[1],
                                                        groups=groups)
    src = src.float()
    if base is not None:
        src = src - base.float()
    return quantize(src, payload_mode(mode))


def _old_decode(q, s, dtype, prev, residual, every, groups):
    """The next buffer from payload q and scales s as parallel/context.py
    computed it: dequantize, add the base, cast, scatter into prev."""
    new = dequantize(q, s, torch.float32)
    if every is None:
        if residual:
            new = prev.float() + new
        return new.to(dtype)
    k, r = every
    if residual:
        new = take_every_kth(prev, k, r, groups=groups).float() + new
    return scatter_every_kth(prev, new.to(dtype), k, r, groups=groups)


def _assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bytes(got), _bytes(want))


# -- fused entries against the unfused composition -------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("r_tensor", [False, True], ids=["r_int", "r_tensor"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mode", MODES)
def test_gather_codec_equals_unfused(mode, k, r_tensor, groups, dtype):
    """A KV payload [B, L, C] of rank 1 coded against its previous slot, and
    the gathered payloads of both ranks decoded into the next buffer."""
    residual = mode == "int8_residual"
    r = (k - 1) if k > 1 else 0
    every = _every(k, r, r_tensor)
    prev = _rows(1, (N, B, L, C), dtype)
    locals_ = [_rows(10 + i, (B, L, C), dtype) for i in range(N)]
    locals_[1][0, 5] = prev[1][0, 5]  # a zero residual row
    coded = []
    for i, local in enumerate(locals_):
        base = prev[i] if residual else None
        want_q, want_s = _old_encode(local, base, every, groups, mode)
        (q, s), = qz.quantize_rows_grouped([qz.EncodeSeg(local, base, every)],
                                           payload_mode(mode))
        _assert_same(q, want_q)
        _assert_same(s, want_s)
        # the contiguous rows as [M, K]: each batch row's chunk is a group
        flat = None if base is None else base.reshape(-1, C)
        (q2, s2), = qz.quantize_rows_grouped(
            [qz.EncodeSeg(local.reshape(-1, C), flat, every)], payload_mode(mode))
        _assert_same(q2, want_q.reshape(-1, C))
        _assert_same(s2, want_s.reshape(-1))
        if base is None and every is None:  # the quantized linears' entry
            q3, s3 = qz.quantize_rows(local.reshape(-1, C), payload_mode(mode))
            _assert_same(q3, q2)
            _assert_same(s3, s2)
        coded.append((q, s))
    gq, gs = torch.stack([c[0] for c in coded]), torch.stack([c[1] for c in coded])
    want = _old_decode(gq, gs, dtype, prev, residual, every, groups)
    base, kept = prev if residual else None, prev if every is not None else None
    got, = qz.dequantize_rows_grouped([qz.DecodeSeg(gq, gs, base, kept, every)], dtype)
    _assert_same(got, want)
    # the two ranks' payloads as parts of a list decode to the same buffer
    got_parts, = qz.dequantize_rows_grouped(
        [qz.DecodeSeg([c[0] for c in coded], [c[1] for c in coded], base, kept, every)],
        dtype)
    _assert_same(got_parts, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mode", MODES)
def test_halo_codec_equals_unfused(mode, k, dtype):
    """The two boundary slabs of x [B, h, W, C] read in place as one
    segment, coded against the sender's own rows under residual coding;
    the two arrived halves decoded (and stacked) into the next buffer, and
    the sender's own rows reconstructed, as the context did it top and
    bottom apart."""
    residual = mode == "int8_residual"
    every = _every(k, 1 % k, as_tensor=k == 4)
    halo, h, w, c = 1, 3, 8, 16
    x = _rows(2, (B, h, w, c), dtype)
    own = _rows(3, (2, B, halo, w, c), dtype)
    prev = _rows(4, (2, B, halo, w, c), dtype)
    x[1, 0, 2] = own[0, 1, 0, 2]  # a zero residual row
    top, bottom = x[:, :halo], x[:, h - halo:]
    slabs = ctx_mod._halo_slabs(x, halo)
    assert slabs.data_ptr() == x.data_ptr() and torch.equal(slabs, torch.stack([top, bottom]))
    (q, s), = qz.quantize_rows_grouped(
        [qz.EncodeSeg(slabs, own if residual else None, every)], payload_mode(mode))
    for i, slab in enumerate((top, bottom)):
        want_q, want_s = _old_encode(slab, own[i] if residual else None, every, 1, mode)
        _assert_same(q[i], want_q)
        _assert_same(s[i], want_s)
    # arrived: from the previous rank (its bottom) and the next (its top)
    arrived_q, arrived_s = [q[1], q[0]], [s[1], s[0]]
    want = torch.stack([_old_decode(qi, si, dtype, prev[i], residual, every, 1)
                        for i, (qi, si) in enumerate(zip(arrived_q, arrived_s))])
    segs = [qz.DecodeSeg(arrived_q, arrived_s, prev if residual else None,
                         prev if every is not None else None, every)]
    if residual:
        segs.append(qz.DecodeSeg(q, s, own, own if every is not None else None, every))
    got = qz.dequantize_rows_grouped(segs, dtype)
    _assert_same(got[0], want)
    if residual:
        want_own = torch.stack([_old_decode(q[i], s[i], dtype, own[i], True, every, 1)
                                for i in range(2)])
        _assert_same(got[1], want_own)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_grouped_entries_equal_per_segment(mode):
    """One grouped call over KV and halo segments writing into a flat byte
    buffer (payloads, then scales) equals the per-segment calls; the
    grouped decode equals the per-segment decodes."""
    pdt = ctx_mod._PAYLOAD_DTYPES[mode]
    segs = [qz.EncodeSeg(_rows(20, (B, L, C), torch.bfloat16)),
            qz.EncodeSeg(_rows(21, (B, L, 2 * C), torch.float32), None, (2, 1)),
            qz.EncodeSeg(ctx_mod._halo_slabs(_rows(22, (B, 4, 8, C), torch.bfloat16), 1)),
            qz.EncodeSeg(_rows(23, (3, 2 * C), torch.bfloat16),
                         _rows(24, (3, 2 * C), torch.bfloat16), (1, 0))]
    single = [qz.quantize_rows_grouped([seg], mode)[0] for seg in segs]
    shapes = [qz.payload_shape(seg.x.shape, seg.every) for seg in segs]
    offsets, total = ctx_mod._layout(shapes)
    buf = torch.zeros(total, dtype=torch.uint8)
    views = [ctx_mod._views(buf, o, shape, pdt) for o, shape in zip(offsets, shapes)]
    got = qz.quantize_rows_grouped([seg._replace(out=v) for seg, v in zip(segs, views)], mode)
    assert len(got) == len(segs)
    for (q, s), (want_q, want_s), (vq, vs) in zip(got, single, views):
        _assert_same(q, want_q)
        _assert_same(s, want_s)
        assert q.data_ptr() == vq.data_ptr() and s.data_ptr() == vs.data_ptr()
    assert total == sum(q.numel() + 4 * s.numel() for q, s in single)  # no padding here
    dsegs = [qz.DecodeSeg(q, s) for q, s in single]
    dsegs[1] = qz.DecodeSeg(*single[1], prev=_rows(25, (B, L, 2 * C), torch.bfloat16),
                            every=(2, torch.tensor(1)))
    grouped = qz.dequantize_rows_grouped(dsegs, torch.bfloat16)
    for got_buf, seg in zip(grouped, dsegs):
        _assert_same(got_buf, qz.dequantize_rows_grouped([seg], torch.bfloat16)[0])


def test_codec_shape_errors_name_the_layer():
    """A row count the period does not divide is refused with the layer's
    name, before anything is encoded."""
    ctx = ctx_mod.PatchContext(n=2, mode="corrected_async_gn", phase="stale",
                               compress="int8", refresh_fraction=0.25, step=1)
    ctx.state_in = {"kv": torch.zeros(2, 1, 6, 4)}
    with pytest.raises(ValueError, match="layer 'kv'.*divisible"):
        ctx.emit_refresh_gather("kv", torch.zeros(1, 6, 4), "attn")
    with pytest.raises(ValueError, match="divisible"):
        qz.payload_shape((2, 6, 4), (4, 0))


# -- the JAX package on the same inputs -------------------------------------

_JAX_CASES = [(k, g) for k in KS for g in (1, 2)]


def _jax_composition(mode):
    """quantize, dequantize, take_every_kth and scatter_every_kth of the JAX
    package composed as a refresh, for every (k, groups) case at once."""
    residual = mode == "int8_residual"

    def run(x, prev, r):
        out = []
        for k, groups in _JAX_CASES:
            rk = r % k
            src = x - prev if residual else x
            sub = jax_compress.take_every_kth(src, k, rk, groups=groups)
            q, s = jax_compress.quantize(sub, mode)
            new = jax_compress.dequantize(q, s, jnp.float32)
            if residual:
                new = jax_compress.take_every_kth(prev, k, rk, groups=groups) + new
            out.append((q, s, jax_compress.scatter_every_kth(prev, new, k, rk,
                                                             groups=groups)))
        return out

    return jax.jit(run)


@pytest.mark.parametrize("mode", MODES)
def test_codec_agrees_with_jax(mode):
    """Payloads equal; scales and buffers within 1e-6 of their largest
    value, for every (k, groups) case, the rotation 1."""
    residual = mode == "int8_residual"
    x = _rows(30, (B, L, C), torch.float32)
    prev = _rows(31, (B, L, C), torch.float32)
    x[1, 2] = prev[1, 2]  # a zero residual row
    r = 1
    got_jax = _jax_composition(mode)(jnp.asarray(x.numpy()), jnp.asarray(prev.numpy()), r)
    for (k, groups), (jq, js, jbuf) in zip(_JAX_CASES, got_jax):
        every = (k, r % k) if k > 1 else None
        (q, s), = qz.quantize_rows_grouped(
            [qz.EncodeSeg(x, prev if residual else None, every)], payload_mode(mode))
        np.testing.assert_array_equal(_bytes(q).numpy(), np.asarray(jq).view(np.uint8))
        js = np.asarray(js)
        assert np.abs(s.numpy() - js).max() <= JAX_TOL * np.abs(js).max()
        buf, = qz.dequantize_rows_grouped(
            [qz.DecodeSeg(q, s, prev if residual else None,
                          prev if every is not None else None, every)], torch.float32)
        jbuf = np.asarray(jbuf)
        assert np.abs(buf.numpy() - jbuf).max() <= JAX_TOL * np.abs(jbuf).max()


# -- the context: one encode and one decode call a payload, or a flush ------


class _Counted:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


def _standin_collectives(monkeypatch):
    """All-gather and halo exchange on one process: the peer sends what
    this rank sends (gather: [x, x]; exchange: from the previous rank its
    bottom, from the next its top)."""
    def all_gather(x, group=None, *, async_op=False):
        p = collectives.Pending([], lambda: torch.stack([x] * N))
        return p if async_op else p.wait()

    def exchange(bottom, top, group=None, *, async_op=False):
        p = collectives.Pending([], lambda: (bottom.clone(), top.clone()))
        return p if async_op else p.wait()

    def batched_all_gather(parts, group=None, *, async_op=False):
        p = collectives.Pending([], lambda: {key: torch.stack([t] * N) for key, t in parts})
        return p if async_op else p.wait()

    monkeypatch.setattr(collectives, "all_gather", all_gather)
    monkeypatch.setattr(collectives, "exchange_boundary_rows", exchange)
    monkeypatch.setattr(collectives, "batched_all_gather", batched_all_gather)


def _stale_step(mode, fraction, batch, dtype=torch.bfloat16):
    """One stale step's emissions (two KV gathers, two halo pairs, GroupNorm
    moments) on a context at rank 1 of 2; returns the context's next
    buffers and the buffers the unfused composition gives."""
    k = round(1 / fraction)
    every = (k, torch.tensor(3) % k) if k > 1 else None
    residual = mode == "int8_residual"
    kvs = {f"kv{i}": _rows(40 + i, (1, L, C * (i + 1)), dtype) for i in range(2)}
    xs = {f"conv{i}": _rows(50 + i, (1, 4, 8, C), dtype) for i in range(2)}
    state = {name: _rows(60 + i, (N, *kv.shape), dtype) for i, (name, kv) in
             enumerate(kvs.items())}
    for i, name in enumerate(xs):
        state[name] = _rows(70 + i, (2, 1, 1, 8, C), dtype)
        state[name + ctx_mod.OWN_SUFFIX] = _rows(80 + i, (2, 1, 1, 8, C), dtype)
    state["gn"] = torch.zeros(N, 2, 1, 4)
    ctx = ctx_mod.PatchContext(n=N, mode="corrected_async_gn", phase="stale", split_idx=1,
                               batch_comm=batch, compress=mode, refresh_fraction=fraction,
                               step=torch.tensor(3), state_in=state)
    for name, kv in kvs.items():
        ctx.emit_refresh_gather(name, kv, "attn")
    for name, x in xs.items():
        ctx.emit_refresh_halos(name, x, 1)
    ctx.emit_refresh_gather("gn", torch.ones(2, 1, 4), "gn")
    ctx.flush()
    got = ctx.finish()

    want = {"gn": torch.ones(N, 2, 1, 4)}
    for name, kv in kvs.items():
        prev = state[name]
        q, s = _old_encode(kv, prev[1] if residual else None, every, 1, mode)
        want[name] = _old_decode(torch.stack([q] * N), torch.stack([s] * N), dtype, prev,
                                 residual, every, 1)
    for name, x in xs.items():
        own, prev = state[name + ctx_mod.OWN_SUFFIX], state[name]
        coded = [_old_encode(slab, own[i] if residual else None, every, 1, mode)
                 for i, slab in enumerate((x[:, :1], x[:, 3:]))]
        arrived = [coded[1], coded[0]]
        want[name] = torch.stack([_old_decode(q, s, dtype, prev[i], residual, every, 1)
                                  for i, (q, s) in enumerate(arrived)])
        if residual:
            want[name + ctx_mod.OWN_SUFFIX] = torch.stack(
                [_old_decode(q, s, dtype, own[i], True, every, 1)
                 for i, (q, s) in enumerate(coded)])
    return got, want


@pytest.mark.parametrize("mode,fraction,batch", [
    ("int8", 1.0, False), ("int8", 0.5, False), ("fp8", 0.25, False),
    ("int8_residual", 0.5, False), ("fp8", 1.0, True), ("int8_residual", 1.0, True)],
    ids=["int8", "int8_pcpp", "fp8_pcpp4", "residual_pcpp", "fp8_batched",
         "residual_batched"])
def test_stale_step_codec_calls_and_buffers(monkeypatch, mode, fraction, batch):
    """Four compressed payloads a step: the encode entry and the decode
    entry are called once each per payload, or once each per flush under
    batch_comm; the next buffers equal the unfused composition's."""
    _standin_collectives(monkeypatch)
    enc = _Counted(ctx_mod.quantize_rows_grouped)
    dec = _Counted(ctx_mod.dequantize_rows_grouped)
    monkeypatch.setattr(ctx_mod, "quantize_rows_grouped", enc)
    monkeypatch.setattr(ctx_mod, "dequantize_rows_grouped", dec)
    got, want = _stale_step(mode, fraction, batch)
    payloads = 4
    assert (enc.calls, dec.calls) == ((1, 1) if batch else (payloads, payloads))
    assert set(got) == set(want)
    for name in want:
        _assert_same(got[name], want[name])
