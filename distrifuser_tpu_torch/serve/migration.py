"""Carry migration: the wire format that moves a mid-denoise request.

Counterpart of distrifuser_tpu/serve/migration.py (``encode_snapshot``,
``decode_snapshot``, ``check_identity``, ``check_key_compatible``,
``CarrySnapshot``), byte-compatible with it: a snapshot either package
writes, the other reads.  A preempted slot's denoise carry parks to host
as an exact byte round-trip and resumes bit-identically; this module takes
that carry across the server boundary -- a **versioned, checksummed,
self-describing serialization** of a `SlotState`'s execution state that
any COMPATIBLE server can import and resume at the same step,
bit-identical to an unmigrated run.

Why bit-identity holds: the carry bytes are exact (host tensors, the same
device->host round-trip preemption pins), the prompt embeddings are
deterministically re-encoded on the importing side (the step path's
`step_begin` machinery -- same tokenizer, same encoders), and the per-step
evaluations an imported carry replays are selected by the SAME `ExecKey`
the exporter ran (compatibility is checked field for field).

Envelope layout (everything before the digest is covered by it)::

    MAGIC(4) | u32 header_len | header json | leaf bytes... | sha256(32)

The JSON header is the self-description: format version, the full
`ExecKey` field dict, the executor family, the step index and total,
the request identity (request_id / seed / prompt crc), and one
shape/dtype/nbytes descriptor per carry leaf.  Leaves follow as raw
C-contiguous bytes in descriptor order.  A bfloat16 leaf (the transformer
KV, stale buffers, bf16 carries) has no numpy type on a machine without
``ml_dtypes``: its two bytes per element are written and read raw, under
the ``"dtype": "bfloat16"`` descriptor the JAX package's header uses, and
it decodes into a ``torch.bfloat16`` tensor bit for bit.  Decoded leaves
are CPU tensors.  A 0-dim tensor (DPM++ 2M's ``lambda_prev``) keeps its
shape ``[]``; a numpy leaf goes through ``np.ascontiguousarray`` as in the
JAX package, which writes a 0-dim array as shape ``[1]``.

Over n ranks (serve/ranks.py) one envelope holds every rank's leaves,
rank 0's first, and its header's ``rank_leaves`` counts each rank's; the
`ExecKey`'s ``mesh_plan`` makes an envelope of another layout fail
`check_key_compatible`, typed, before any executor sees it.

Every validation failure -- truncation, bad magic, version skew,
checksum mismatch, malformed header, leaf-descriptor drift, ExecKey or
identity incompatibility -- raises `MigrationRejectedError` (typed,
retryable): the caller strips the snapshot and falls back to a
from-step-0 retry, never silent corruption.

Thread model: pure functions over immutable inputs plus the frozen
`CarrySnapshot` decoded form -- no shared mutable state; safe from any
thread.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .cache import ExecKey
from .errors import MigrationRejectedError

MAGIC = b"DFCM"  # DistriFuser Carry Migration
FORMAT_VERSION = 1

_HEADER_LEN = struct.Struct(">I")
_DIGEST_BYTES = 32  # sha256


def prompt_crc(prompt: str) -> int:
    """Identity fingerprint of a prompt for the header -- the snapshot
    must not resume under a different prompt's re-encoded embeddings,
    but the full text already travels in the re-dispatch params, so the
    header carries only the check value."""
    return zlib.crc32(prompt.encode("utf-8"))


_BF16 = "bfloat16"
_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, _BF16: torch.bfloat16, "int64": torch.int64,
    "int32": torch.int32, "int16": torch.int16, "int8": torch.int8,
    "uint8": torch.uint8, "bool": torch.bool,
}
_TORCH_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _leaf_bytes(leaf) -> Tuple[Tuple[int, ...], str, bytes]:
    """(shape, dtype name, C-contiguous bytes) of a torch tensor or a
    numpy array; bfloat16 as its raw two bytes per element."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype not in _TORCH_NAMES:
            raise TypeError(f"carry leaf dtype {t.dtype} has no snapshot name")
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return tuple(t.shape), _TORCH_NAMES[t.dtype], raw.numpy().tobytes()
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.shape, arr.dtype.name, arr.tobytes()


def _leaf_from_bytes(buf, offset: int, shape, name: str) -> torch.Tensor:
    """The CPU tensor of one described leaf (a copy of its bytes)."""
    if name == _BF16:
        count = int(np.prod(shape, dtype=np.int64))
        raw = np.frombuffer(buf, dtype=np.int16, count=count, offset=offset)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16).reshape(shape)
    dtype = np.dtype(name)
    if dtype.name not in _TORCH_DTYPES:
        raise TypeError(f"no tensor dtype for {dtype.name}")
    count = int(np.prod(shape, dtype=np.int64))
    arr = np.frombuffer(buf, dtype=dtype, count=count, offset=offset)
    return torch.from_numpy(arr.reshape(shape).copy())


def _itemsize(name: str) -> int:
    return 2 if name == _BF16 else np.dtype(name).itemsize


@dataclasses.dataclass(frozen=True)
class CarrySnapshot:
    """Decoded (validated) form of one carry snapshot.

    ``meta`` is the parsed JSON header; ``leaves`` are the carry's CPU
    tensors in flatten order.  Frozen -- a decoded snapshot is import
    input, never mutated (the importing executor builds a FRESH work dict
    around the leaves)."""

    meta: Dict[str, Any]
    leaves: Tuple[torch.Tensor, ...]

    @property
    def step(self) -> int:
        return int(self.meta["step"])

    @property
    def steps_total(self) -> int:
        return int(self.meta["steps_total"])

    @property
    def family(self) -> str:
        return str(self.meta["family"])

    @property
    def exec_key(self) -> Dict[str, Any]:
        return dict(self.meta["exec_key"])


def encode_snapshot(*, ekey: ExecKey, family: str, step: int,
                    steps_total: int, request_id: str, prompt: str,
                    seed: int, leaves: List[Any],
                    extra: Optional[Dict[str, Any]] = None) -> bytes:
    """Serialize one parked carry (torch tensors or numpy arrays) to the
    self-describing envelope."""
    host = [_leaf_bytes(leaf) for leaf in leaves]
    meta: Dict[str, Any] = {
        "format": FORMAT_VERSION,
        "family": family,
        "exec_key": dataclasses.asdict(ekey),
        "step": int(step),
        "steps_total": int(steps_total),
        "request_id": request_id,
        "seed": int(seed),
        "prompt_crc": prompt_crc(prompt),
        "leaves": [
            {"shape": list(shape), "dtype": name, "nbytes": len(raw)}
            for shape, name, raw in host
        ],
    }
    if extra:
        meta.update(extra)
    header = json.dumps(meta, sort_keys=True).encode("utf-8")
    body = bytearray()
    body += MAGIC
    body += _HEADER_LEN.pack(len(header))
    body += header
    for _, _, raw in host:
        body += raw
    body += hashlib.sha256(bytes(body)).digest()
    return bytes(body)


def decode_snapshot(data: bytes) -> CarrySnapshot:
    """Validate and decode an envelope; every failure is typed.

    Order matters: the checksum is verified FIRST (over everything
    before the digest), so a flipped bit anywhere -- header or payload --
    rejects as corruption before any field is trusted; only then are
    magic, version, header shape, and leaf descriptors interpreted."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        raise MigrationRejectedError(
            f"carry snapshot must be bytes, got {type(data).__name__}"
        )
    data = bytes(data)
    floor = len(MAGIC) + _HEADER_LEN.size + _DIGEST_BYTES
    if len(data) < floor:
        raise MigrationRejectedError(
            f"carry snapshot truncated: {len(data)} bytes < the "
            f"{floor}-byte envelope floor"
        )
    payload, digest = data[:-_DIGEST_BYTES], data[-_DIGEST_BYTES:]
    if hashlib.sha256(payload).digest() != digest:
        raise MigrationRejectedError(
            "carry snapshot checksum mismatch: payload corrupt or "
            "truncated in flight"
        )
    if payload[:len(MAGIC)] != MAGIC:
        raise MigrationRejectedError(
            f"carry snapshot bad magic {payload[:len(MAGIC)]!r} "
            f"(want {MAGIC!r})"
        )
    (header_len,) = _HEADER_LEN.unpack_from(payload, len(MAGIC))
    header_off = len(MAGIC) + _HEADER_LEN.size
    if header_off + header_len > len(payload):
        raise MigrationRejectedError(
            "carry snapshot truncated: header extends past the payload"
        )
    try:
        meta = json.loads(payload[header_off:header_off + header_len])
    except ValueError as exc:
        raise MigrationRejectedError(
            f"carry snapshot header is not valid JSON: {exc}"
        ) from exc
    version = meta.get("format")
    if version != FORMAT_VERSION:
        raise MigrationRejectedError(
            f"carry snapshot format version {version!r} is not the "
            f"supported {FORMAT_VERSION} -- refusing cross-version import"
        )
    for field in ("family", "exec_key", "step", "steps_total", "seed",
                  "prompt_crc", "leaves"):
        if field not in meta:
            raise MigrationRejectedError(
                f"carry snapshot header missing field {field!r}"
            )
    leaves: List[torch.Tensor] = []
    off = header_off + header_len
    for i, desc in enumerate(meta["leaves"]):
        try:
            shape = tuple(int(d) for d in desc["shape"])
            name = str(desc["dtype"])
            itemsize = _itemsize(name)
            nbytes = int(desc["nbytes"])
        except (KeyError, TypeError, ValueError) as exc:
            raise MigrationRejectedError(
                f"carry snapshot leaf {i} descriptor malformed: {exc}"
            ) from exc
        expect = int(np.prod(shape, dtype=np.int64)) * itemsize
        if nbytes != expect:
            raise MigrationRejectedError(
                f"carry snapshot leaf {i} descriptor inconsistent: "
                f"{nbytes} bytes for shape {shape} {name} "
                f"(want {expect})"
            )
        if off + nbytes > len(payload):
            raise MigrationRejectedError(
                f"carry snapshot truncated inside leaf {i}"
            )
        try:
            leaves.append(_leaf_from_bytes(payload, off, shape, name))
        except (TypeError, ValueError) as exc:
            raise MigrationRejectedError(
                f"carry snapshot leaf {i} dtype {name!r} unreadable: {exc}"
            ) from exc
        off += nbytes
    if off != len(payload):
        raise MigrationRejectedError(
            f"carry snapshot has {len(payload) - off} trailing bytes "
            "after the last described leaf"
        )
    return CarrySnapshot(meta=meta, leaves=tuple(leaves))


def check_identity(snap: CarrySnapshot, *, prompt: str,
                   seed: int) -> None:
    """The snapshot must belong to the request being re-dispatched --
    resuming someone else's latent under this request's identity would
    be silent cross-request corruption."""
    if int(snap.meta["seed"]) != int(seed):
        raise MigrationRejectedError(
            f"carry snapshot seed {snap.meta['seed']} does not match "
            f"the re-dispatched request's seed {seed}"
        )
    if int(snap.meta["prompt_crc"]) != prompt_crc(prompt):
        raise MigrationRejectedError(
            "carry snapshot prompt fingerprint does not match the "
            "re-dispatched request's prompt"
        )


def check_key_compatible(snap: CarrySnapshot, ekey: ExecKey) -> None:
    """Field-for-field ExecKey equality -- the strict rule.

    Every key field is executor identity (bucket, steps, cfg, mesh plan,
    cadence, compression, quantization, exec mode...), and bit-identity
    of the resumed run is only guaranteed when the importer replays the
    EXACT per-step evaluations the exporter ran, so any drift -- even
    a ladder/tier rung difference between servers -- rejects typed and
    falls back to from-step-0 rather than resuming under different
    numerics."""
    want = snap.exec_key
    have = dataclasses.asdict(ekey)
    if want != have:
        diff = sorted(
            k for k in set(want) | set(have) if want.get(k) != have.get(k)
        )
        raise MigrationRejectedError(
            "carry snapshot ExecKey incompatible with the importing "
            f"server's key (differs in {', '.join(diff)}): exporter "
            f"{want}, importer {have}"
        )
