"""Run configuration and process groups for the PyTorch port.

Counterpart of distrifuser_tpu/utils/config.py:DistriConfig.  Field names,
defaults and validation follow the JAX package; the mesh gives way to an
explicit ``device`` and to torch.distributed process groups, as in the
original DistriFusion:

* the rank and the world size are read from the process group that the
  caller initialised (torchrun, ``torch.multiprocessing.spawn``, a test
  harness).  The library never picks a backend: NCCL on cards, gloo on the
  CPU or for ranks that share one card, as the caller chose;
* the world splits into ``dp_degree`` image groups of ``group_size =
  world / dp_degree`` consecutive ranks, each running its share of the
  batch on its own (the JAX ``dp`` axis).  Within an image group, under
  CFG with ``split_batch``, two branches of ``n_device_per_batch`` ranks:
  ``batch_group`` holds the n patch peers of one branch (the JAX ``sp``
  axis), ``split_group`` the two ranks that hold the same patch of either
  branch (the ``cfg`` axis); without the split ``batch_group`` is the
  whole image group and there is no ``split_group``.  ``dp_group`` holds
  the ranks at the same place of every image group, which gather the
  groups' images.  Rank r has ``dp_idx = r // group_size``, ``batch_idx =
  (r % group_size) // n`` and ``split_idx = r % n``, the JAX mesh's
  ``reshape(dp, cfg, n)`` order.  Each of these is a *data group* of its
  own, the whole world's too (never the default group): the serve plane
  over n ranks aborts them after a failure inside an operation and makes
  them anew (``abort_data_groups``, ``rebuild_data_groups``), with a
  timeout it derives from its watchdog bound (``set_data_group_watchdog``);
  its commands ride one more gloo group, ``control_group()``, which it
  never aborts (serve/ranks.py).

Under ``attn_impl="usp"`` each patch group of n ranks is factored as
``ulysses_degree`` x r (the JAX ``usp_mesh``): the rank at patch index
``u_idx * r + r_idx`` holds ``sp_u_group`` (the ``ulysses_degree`` ranks of
its ``r_idx``, the head-sharding all-to-all) and ``sp_r_group`` (the r
ranks of its ``u_idx``, the ring); a group of one rank is None.

``pipe_patches`` (PipeFusion's token chunks, parallel/pipefusion.py) is
accepted under ``parallelism="pipefusion"`` and refused elsewhere, as the
JAX package refuses it.  The comm knobs of
the displaced patch path (``comm_batch``, ``comm_compress``,
``refresh_fraction``, the step cache, ``attn_impl`` "ring", "ulysses" and
"usp" and ``ulysses_degree``) are validated as the JAX package validates
them.
Two knobs are carried
with no effect: ``comm_checkpoint``, the reference's NCCL flush interval,
which a compiled step (a CUDA graph, or the JAX package's XLA program) has
no queue for, still checked to be a positive int; and ``hybrid_loop``, the
JAX package's per-step warm-up loop in front of one compiled stale loop,
where the port always runs step by step with one graph per phase (the same
numerics), still refused with the step cache as the JAX package refuses
it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..parallel.compress import (validate_mode, validate_quant_compute,
                                 validate_refresh_fraction, validate_weight_mode)
from .env import is_power_of_2, resolve_device

SYNC_MODES = (
    "separate_gn",
    "stale_gn",
    "corrected_async_gn",
    "sync_gn",
    "full_sync",
    "no_sync",
)
PARALLELISMS = ("patch", "tensor", "naive_patch", "pipefusion")
SPLIT_SCHEMES = ("row", "col", "alternate")
ATTN_IMPLS = ("gather", "ring", "ulysses", "usp")


def validate_step_cache_knobs(interval: int, depth: int) -> None:
    """The step-cache pairing rule (JAX utils/config.py:62): both knobs on,
    or both off."""
    if interval < 1:
        raise ValueError(f"step_cache_interval must be >= 1, got {interval}")
    if depth < 0:
        raise ValueError(f"step_cache_depth must be >= 0, got {depth}")
    if (interval > 1) != (depth > 0):
        raise ValueError(
            "step-cache needs BOTH knobs: step_cache_interval >= 2 picks "
            "the full/shallow cadence and step_cache_depth >= 1 picks how "
            f"deep the shallow steps cut (got interval={interval}, "
            f"depth={depth})"
        )

# Process groups already built, keyed by (kind, default group, generation,
# *shape): every config of a run shares them, and every rank builds them in
# one order.  The *data* groups (every group a collective of the model
# runs on: batch, split, dp, usp's two, the serve fakes' named ones) carry
# the generation of the data groups, ``_GENERATION``; the serve plane's
# control group does not.  ``rebuild_data_groups`` starts the next
# generation: it makes every data group of the last one anew, in the order
# they were first made, so a group that timed out or was aborted is never
# used again (serve/ranks.py).
_GROUPS: Dict[Tuple[Any, ...], Any] = {}
_GENERATION = 0
# the calls that made this generation's data groups, in order: (kind,
# shape, fn, args), as `_remember` took them
_MADE: List[Tuple[str, Tuple[Any, ...], Callable[..., Any], Tuple[Any, ...]]] = []
# the data groups of this generation this rank belongs to (to abort), and
# whether they were aborted
_MEMBER_GROUPS: List[Any] = []
_ABORTED = False
# the watchdog bound the data groups' timeout derives from (seconds);
# None: torch's default timeout (every path but serving over ranks)
_WATCHDOG_S: Optional[float] = None
_ABORT_WAIT_S = 2.0  # how long `abort_data_groups` waits for its aborts


def data_group_timeout(watchdog_s: float, backend: str) -> float:
    """The timeout a data group gets under a server whose watchdog bound is
    ``watchdog_s`` (serve/ranks.py).  On NCCL twice the bound: rank 0
    aborts the groups at the latest when its watchdog fires, before NCCL's
    own timeout would tear the process down.  On gloo, which cannot abort,
    the bound itself: ranks that share a card start cold at times that
    differ by many seconds, and a wait that long must not read as a
    failure; a rank left waiting by a peer that failed leaves at the latest
    one bound after it entered, so the command it holds ends within the
    bound the server's rebuild then waits (its watchdog, firing first,
    reads the peer's failure: `RankLeader.abort_cause`)."""
    return (2.0 if "nccl" in backend else 1.0) * watchdog_s


def set_data_group_watchdog(watchdog_s: Optional[float]) -> bool:
    """Derive the data groups' timeout from a server's watchdog bound
    (``ResilienceConfig.watchdog_timeout_s``; <= 0 or None: torch's
    default).  Returns whether the bound changed while data groups exist,
    in which case the caller rebuilds them on every rank
    (`serve.ranks.serve_over_ranks` does)."""
    global _WATCHDOG_S
    bound = float(watchdog_s) if watchdog_s and watchdog_s > 0 else None
    changed = bound != _WATCHDOG_S
    _WATCHDOG_S = bound
    return changed and bool(_MADE)


def _data_group(ranks: Sequence[int], backend: Optional[str] = None):
    """``dist.new_group`` for a data group of this generation, with the
    timeout `set_data_group_watchdog` derived (torch's default without
    one).  Collective over the world, as every ``new_group``."""
    kw: Dict[str, Any] = {}
    if backend is not None:
        kw["backend"] = backend
    if _WATCHDOG_S is not None:
        import datetime

        name = backend or dist.get_backend()
        kw["timeout"] = datetime.timedelta(
            seconds=data_group_timeout(_WATCHDOG_S, str(name)))
    group = dist.new_group(list(ranks), **kw)
    if dist.is_initialized() and dist.get_rank() in ranks:
        _MEMBER_GROUPS.append(group)
    return group


def _remember(kind: str, shape: Tuple[Any, ...], fn: Callable[..., Any],
              args: Tuple[Any, ...]):
    """The data groups of ``kind`` at ``shape`` of this generation, made
    by ``fn(*args)`` on first use and recorded, so that
    ``rebuild_data_groups`` can make them anew."""
    key = (kind, dist.group.WORLD, _GENERATION, *shape)
    if key not in _GROUPS:
        _GROUPS[key] = fn(*args)
        _MADE.append((kind, shape, fn, args))
    return _GROUPS[key]


def data_group_generation() -> int:
    """The generation of the data groups: 0, one more after each
    `rebuild_data_groups`."""
    return _GENERATION


def data_groups_live(generation: int) -> bool:
    """Are the data groups of ``generation`` still the ones to use (the
    current generation, not aborted)?  A CUDA graph captured over them
    replays only while they are (parallel/graphs.py)."""
    return generation == _GENERATION and not _ABORTED


def abort_data_groups() -> int:
    """Abort this rank's NCCL data groups of the current generation
    (``_abort_process_group``), so that no later work of this generation
    can wait on one: a collective waiting on the card for a peer that left
    ends.  The groups are aborted together, a daemon thread each, and this
    waits at most ``_ABORT_WAIT_S`` in all: a group's own abort call may not
    return before the group's timeout (seen on H100s with NCCL 2.28, which
    then log that it timed out), and nothing here needs it to.  Gloo has no
    abort: a rank waiting in a gloo collective leaves it through the
    group's timeout.  Returns the number of groups aborted."""
    import threading
    import time

    from torch.distributed.distributed_c10d import _abort_process_group

    global _ABORTED
    _ABORTED = True
    groups = [g for g in _MEMBER_GROUPS if "nccl" in str(dist.get_backend(g))]
    threads = [threading.Thread(target=_abort_process_group, args=(g,), daemon=True,
                                name="abort-data-group") for g in groups]
    for t in threads:
        t.start()
    deadline = time.monotonic() + _ABORT_WAIT_S
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    return len(groups)


def rebuild_data_groups() -> int:
    """Start the next generation of data groups: make every data group of
    the last one anew, in the order they were first made.  Collective over
    the world (``dist.new_group``): every rank calls it at the same point
    of its order of groups, after every rank has left the operations of
    the last generation.  The old groups are left to the references that
    still hold them (an abandoned thread may still be inside one of them),
    never used again.  Returns the new generation."""
    global _GENERATION, _ABORTED
    made = list(_MADE)
    stale = [k for k in _GROUPS if k[0] != "control"]
    for k in stale:
        del _GROUPS[k]
    _MADE.clear()
    _MEMBER_GROUPS.clear()
    _GENERATION += 1
    _ABORTED = False
    for kind, shape, fn, args in made:
        _remember(kind, shape, fn, args)
    return _GENERATION


def named_data_group(name: str, backend: Optional[str] = None):
    """A data group over the whole world under ``name`` (the serve
    plane's collective fakes hold theirs so): made once a generation, on
    every rank in one order, and anew by ``rebuild_data_groups``."""
    world = dist.get_world_size()
    return _remember("named", (world, name, backend), _data_group, (range(world), backend))


def _process_groups(world: int, n: int, rank: int, dp: int = 1):
    """(batch_group, split_group, dp_group) of this rank, after the
    reference's utils.py:84-96 within each of the ``dp`` image groups of
    world / dp consecutive ranks; ``split_group`` is None without the CFG
    split (n is the image group), ``dp_group`` None at dp 1.  Every group
    is a data group of its own, the whole world's too: never the default
    group, which an abort would take down with every later ``new_group``.
    ``dist.new_group`` is collective over the world: every rank creates
    every group, in the same order, including the groups it is not in."""
    return _remember("patch", (world, dp, n), _make_process_groups, (world, n, rank, dp))


def _make_process_groups(world: int, n: int, rank: int, dp: int):
    size = world // dp  # ranks of an image group
    batch = [_data_group(range(b * n, (b + 1) * n)) for b in range(world // n)]
    split = [None] * (world // n)
    if n < size:  # two branches an image group
        split = [_data_group([g * size + s, g * size + s + n])
                 for g in range(dp) for s in range(n)]
    dp_groups = [None] * size
    if dp > 1:
        dp_groups = [_data_group(range(p, world, size)) for p in range(size)]
    image, place = rank // size, rank % size
    return (batch[rank // n], split[image * n + place % n] if n < size else None,
            dp_groups[place])


def control_group():
    """The serve plane's control channel over the world (serve/ranks.py):
    one gloo group, whatever backend the data groups use, that carries
    nothing but rank 0's commands to the other ranks and their statuses
    back.  Created once, on every rank, before any executor is built (so
    in the same place of every rank's order of groups); its timeout is a
    week, because a follower waits on it for the next command while the
    server idles.  Never aborted nor rebuilt.  None at world 1."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    if world == 1:
        return None
    key = ("control", dist.group.WORLD, world)
    if key not in _GROUPS:
        import datetime

        _GROUPS[key] = dist.new_group(list(range(world)), backend="gloo",
                                      timeout=datetime.timedelta(days=7))
    return _GROUPS[key]


def _usp_groups(world: int, n: int, rank: int, u: int, batch_group):
    """(sp_u_group, sp_r_group) of this rank: each patch group of n
    consecutive ranks factored as u x r, r = n / u, patch index ``u_idx * r
    + r_idx`` (JAX ``usp_mesh``).  ``sp_u_group`` holds the u ranks of this
    rank's ``r_idx``, ``sp_r_group`` the r ranks of its ``u_idx``; a group
    of one rank is None, one of the whole patch group is ``batch_group``.
    Every rank creates every group, in one order."""
    r = n // u
    if u == 1 or r == 1:
        return (batch_group, None) if r == 1 else (None, batch_group)
    u_groups, r_groups = _remember("usp", (world, n, u), _make_usp_groups, (world, n, u))
    g, s = rank // n, rank % n
    return u_groups[g * r + s % r], r_groups[g * u + s // r]


def _make_usp_groups(world: int, n: int, u: int):
    r = n // u
    u_groups = [_data_group([g + ui * r + ri for ui in range(u)])
                for g in range(0, world, n) for ri in range(r)]
    r_groups = [_data_group([g + ui * r + ri for ri in range(r)])
                for g in range(0, world, n) for ui in range(u)]
    return u_groups, r_groups


@dataclasses.dataclass
class DistriConfig:
    """Run parameters: image size, CFG, sync mode, dtype, weight
    quantization, device and the rank's process groups.

    ``device`` None means the CUDA card of this rank's local rank (raises
    if there is none); ``dtype`` None means bf16 on the card and float32 on
    the CPU, as the JAX package defaults to bf16 on the TPU and float32 on
    the CPU.  The card's kernels take bf16 only, so another dtype on a
    CUDA device is refused.

    ``warmup_steps`` counts the synchronous steps after the first: steps
    0..warmup_steps run with fresh activations, the rest with one-step-
    stale peer activations (``mode``), as the reference counts them.

    ``weight_quant`` ("none", "int8", "fp8") holds the denoiser's matmul
    and conv kernels as 1-byte payloads with one float32 scale per output
    channel (models/weights.py ``quantize_params``; the UNet's ``conv_out``
    stays dense); ``weight_quant_aux`` does the same for the text encoders
    and the VAE, which always densify at the consumer.  ``quant_compute``
    says how the denoiser's quantized linears execute (ops/gemm_routing.py):
    "off" densifies them, "auto" picks per shape, "dot" forces the library
    8-bit GEMM and "pallas" the hand-written kernel of ops/quant_matmul.py.

    ``use_cuda_graph`` (alias ``use_compiled_step``, the JAX package's name
    for its compiled step) runs each UNet evaluation from static buffers:
    on a CUDA device every phase is captured once into a CUDA graph and
    replayed (parallel/graphs.py), and a failed capture raises; on the CPU
    the same static-buffer step runs with no capture.  Ranks that share a
    card (a gloo group staging CUDA payloads through the host) cannot be
    captured and must pass False.  ``parallelism`` "patch" is displaced
    patch parallelism, "naive_patch" slices the latent by ``split_scheme``
    ("row", "col", or "alternate" between them by step parity) and runs
    the dense UNet on the slice, "tensor" shards heads and channels
    (models/unet_tp.py), "pipefusion" splits the DiT's blocks into
    pipeline stages over the patch group with ``pipe_patches`` token
    chunks (default: one a stage) streaming through them
    (parallel/pipefusion.py; it needs ``use_cuda_graph``).  ``verbose`` prints the per-layer stale-buffer
    sizes once the first generation has seeded them
    (``DenoiseRunner.comm_volume_report``); ``comm_checkpoint`` is carried
    with no effect (module docstring).

    The comm knobs of the displaced patch path (parallelism "patch"), as in
    the JAX package: ``comm_compress`` ("int8", "fp8", "int8_residual")
    sends the stale refreshes of halos and KV as 8-bit payloads with one
    float32 scale per row (GroupNorm moments and synchronous exchanges stay
    exact); ``refresh_fraction`` 1/k refreshes one of k strided row groups
    per stale step (PCPP); ``comm_batch`` exchanges every refresh of a step
    in one flat all-gather per dtype and one flat halo pair; the step cache
    (``step_cache_interval`` I >= 2 with ``step_cache_depth`` K >= 1) runs
    the whole UNet once every I steps after the warmup and only its shallow
    levels in between (parallel/stepcache.py); ``attn_impl="ring"`` streams
    the peers' KV chunks around the patch group instead of gathering them
    (ops/ring_attention.py).  The DiT's exact head-sharded layouts:
    ``attn_impl="ulysses"`` re-shards each block's q, k and v from token
    rows to heads by an all-to-all over the patch group and back after the
    attention; ``"usp"`` factors the patch group as ``ulysses_degree`` x r,
    the all-to-all over the first factor and an exact ring over the second
    (ops/ulysses.py).

    ``vae_sp`` picks the decode where the image is in patches and the
    latent rows divide among them: then each patch group decodes its rows
    sequence-parallel (models/vae.py ``decode_sp``, exact, so the same
    image as the whole decode), as the JAX package does.  In every other
    case a latent taller than 128 rows (an image above 1024 px) decodes in
    row tiles of 64, as the JAX package does.

    ``dp_degree`` splits the world into independent image groups, each
    running ``batch_size / dp_degree`` of the images (cfg x sp ranks each);
    every rank returns the whole batch, in order.
    """

    height: int = 1024
    width: int = 1024
    do_classifier_free_guidance: bool = True
    split_batch: bool = True
    warmup_steps: int = 4
    comm_checkpoint: int = 60
    mode: str = "corrected_async_gn"
    use_cuda_graph: bool = True
    parallelism: str = "patch"
    split_scheme: str = "row"
    verbose: bool = False
    attn_impl: str = "gather"
    ulysses_degree: int = 1
    dp_degree: int = 1
    comm_batch: bool = False
    comm_compress: str = "none"
    refresh_fraction: float = 1.0
    step_cache_interval: int = 1
    step_cache_depth: int = 0
    hybrid_loop: bool = False
    pipe_patches: Optional[int] = None
    dtype: Any = None
    batch_size: int = 1
    weight_quant: str = "none"
    weight_quant_aux: str = "none"
    quant_compute: str = "auto"
    vae_sp: bool = True
    device: Any = None

    # derived in __post_init__
    world_size: int = dataclasses.field(init=False, default=1)
    rank: int = dataclasses.field(init=False, default=0)
    n_device_per_batch: int = dataclasses.field(init=False, default=1)
    batch_group: Optional[Any] = dataclasses.field(init=False, default=None, repr=False)
    split_group: Optional[Any] = dataclasses.field(init=False, default=None, repr=False)
    dp_group: Optional[Any] = dataclasses.field(init=False, default=None, repr=False)
    sp_u_group: Optional[Any] = dataclasses.field(init=False, default=None, repr=False)
    sp_r_group: Optional[Any] = dataclasses.field(init=False, default=None, repr=False)

    def __post_init__(self) -> None:
        self._validate()
        self.world_size, self.rank = _world_and_rank()
        world = self.world_size
        if not is_power_of_2(world):
            raise ValueError(f"world size must be a power of 2, got {world}")
        if world % self.dp_degree != 0:
            raise ValueError(
                f"dp_degree {self.dp_degree} must divide world size {world}")
        if self.batch_size % self.dp_degree != 0:
            raise ValueError(
                f"batch_size {self.batch_size} must be divisible by dp_degree "
                f"{self.dp_degree}")
        # the rank's card is current before any group talks NCCL
        self.device = resolve_device(self.device, self.rank)
        group = self.group_size
        if self.do_classifier_free_guidance and self.split_batch:
            self.n_device_per_batch = max(group // 2, 1)
        else:
            self.n_device_per_batch = group
        n = self.n_device_per_batch
        if self.attn_impl == "usp" and n % self.ulysses_degree:
            raise ValueError(f"ulysses_degree {self.ulysses_degree} must divide the sp "
                             f"degree {n}")
        if world > 1:
            self.batch_group, self.split_group, self.dp_group = _process_groups(
                world, n, self.rank, self.dp_degree)
            if self.attn_impl == "usp":
                self.sp_u_group, self.sp_r_group = _usp_groups(
                    world, n, self.rank, self.ulysses_degree, self.batch_group)
        if self.dtype is None:
            self.dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32

    def _validate(self) -> None:
        if self.mode not in SYNC_MODES:
            raise ValueError(f"mode must be one of {SYNC_MODES}, got {self.mode!r}")
        if self.parallelism not in PARALLELISMS:
            raise ValueError(
                f"parallelism must be one of {PARALLELISMS}, got {self.parallelism!r}"
            )
        if self.split_scheme not in SPLIT_SCHEMES:
            raise ValueError(
                f"split_scheme must be one of {SPLIT_SCHEMES}, got {self.split_scheme!r}")
        if not isinstance(self.comm_checkpoint, int) or self.comm_checkpoint < 1:
            raise ValueError(
                f"comm_checkpoint must be a positive int, got {self.comm_checkpoint!r}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(
                "attn_impl must be 'gather', 'ring', 'ulysses', or 'usp' "
                f"(ulysses/usp: DiT only), got {self.attn_impl!r}")
        if self.height % 8 != 0 or self.width % 8 != 0:
            raise ValueError("height and width must be multiples of 8")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.warmup_steps < 0:
            raise ValueError(f"warmup_steps must be >= 0, got {self.warmup_steps}")
        if self.dp_degree < 1:
            raise ValueError(f"dp_degree must be >= 1, got {self.dp_degree}")
        if self.ulysses_degree < 1:
            raise ValueError(f"ulysses_degree must be >= 1, got {self.ulysses_degree}")
        validate_weight_mode(self.weight_quant)
        validate_weight_mode(self.weight_quant_aux)
        validate_quant_compute(self.quant_compute, self.weight_quant)
        if self.weight_quant != "none" and self.parallelism == "tensor":
            raise ValueError(
                "weight_quant quantizes whole kernels ahead of the mesh split; "
                "parallelism='tensor' pre-shards its param tree and would "
                "silently densify the payloads; keep weight_quant='none' there"
            )
        validate_mode(self.comm_compress)
        if (self.comm_compress != "none"
                and self.parallelism not in ("patch", "pipefusion")):
            raise ValueError(
                "comm_compress targets the displaced-patch refresh exchanges "
                "(parallelism='patch') or the PipeFusion inter-stage hops; "
                f"{self.parallelism!r} has no stale refresh traffic to compress"
            )
        validate_refresh_fraction(self.refresh_fraction)
        if self.refresh_fraction < 1.0:
            if self.parallelism != "patch":
                raise ValueError(
                    "refresh_fraction < 1 (PCPP partial refresh) rides the "
                    "displaced-patch stale-refresh exchanges "
                    f"(parallelism='patch'); {self.parallelism!r} has no "
                    "per-step refresh traffic to thin"
                )
            if self.comm_batch:
                raise ValueError(
                    "refresh_fraction < 1 and comm_batch are mutually "
                    "exclusive: the flat batched exchange defers whole-buffer "
                    "records; use the per-layer path for partial refresh"
                )
        validate_step_cache_knobs(self.step_cache_interval, self.step_cache_depth)
        if self.step_cache_enabled and self.parallelism not in ("patch", "pipefusion"):
            raise ValueError(
                "step-cache rides the displaced-patch buffers "
                "(parallelism='patch') or the PipeFusion per-stage carry; "
                f"{self.parallelism!r} has no cross-step activation carry to "
                "keep the deep cache in"
            )
        if self.step_cache_enabled and self.hybrid_loop:
            raise ValueError(
                "step-cache and hybrid_loop are mutually exclusive: the cadence "
                "adds a second (shallow) body to the steady-state loop, which "
                "defeats hybrid's one-body rationale; use the full loop with "
                "the step cache"
            )
        if self.ulysses_degree > 1 and self.attn_impl != "usp":
            raise ValueError(
                "ulysses_degree applies to attn_impl='usp' only (pure "
                "head-sharding is attn_impl='ulysses')"
            )
        if self.pipe_patches is not None:
            if self.parallelism != "pipefusion":
                raise ValueError(
                    "pipe_patches configures the PipeFusion patch stream "
                    f"(parallelism='pipefusion'); {self.parallelism!r} has no "
                    "pipeline to stream patches through")
            if self.pipe_patches < 1:
                raise ValueError(f"pipe_patches must be >= 1, got {self.pipe_patches}")
        on_card = self.device is None or torch.device(self.device).type == "cuda"
        if on_card and self.dtype is not None and self.dtype != torch.bfloat16:
            raise ValueError(
                f"dtype {self.dtype} on a CUDA device: the card's kernels "
                "(flash attention, quantized matmul) have bf16 instances only "
                "(ROADMAP queue 3 fault 2, fixed by refusing); fp16/fp32 "
                "instances are ROADMAP queue 2 item 4.  Use bf16 on the card, "
                "or device='cpu' for float32"
            )

    @property
    def group_size(self) -> int:
        """Ranks an image group (world / dp_degree)."""
        return self.world_size // self.dp_degree

    @property
    def cfg_split(self) -> bool:
        """CFG branches on separate ranks (JAX utils/config.py:438-444)."""
        return (self.do_classifier_free_guidance and self.split_batch
                and self.group_size >= 2)

    @property
    def use_compiled_step(self) -> bool:
        """The JAX package's name for ``use_cuda_graph``: run each UNet
        evaluation as one captured program (JAX utils/config.py:424-426)."""
        return self.use_cuda_graph

    @property
    def step_cache_enabled(self) -> bool:
        """Is the temporal step-cache cadence on (parallel/stepcache.py)?"""
        return self.step_cache_interval > 1 and self.step_cache_depth > 0

    @property
    def is_sp(self) -> bool:
        """Is the image split into patches across ranks (displaced or
        naive patch parallelism)?"""
        return (self.parallelism in ("patch", "naive_patch")
                and self.n_device_per_batch > 1)

    def batch_idx(self, rank: Optional[int] = None) -> int:
        """CFG branch of ``rank`` (default this rank): ranks [0, n) of an
        image group hold branch 0 (unconditional), [n, 2n) branch 1, under
        the split."""
        rank = self.rank if rank is None else rank
        if not self.cfg_split:
            return 0
        return (rank % self.group_size) // self.n_device_per_batch

    def split_idx(self, rank: Optional[int] = None) -> int:
        """Patch index of ``rank`` (default this rank) within its branch."""
        rank = self.rank if rank is None else rank
        return rank % self.n_device_per_batch

    def dp_idx(self, rank: Optional[int] = None) -> int:
        """Image group of ``rank`` (default this rank)."""
        rank = self.rank if rank is None else rank
        return rank // self.group_size

    @property
    def latent_height(self) -> int:
        return self.height // 8

    @property
    def latent_width(self) -> int:
        return self.width // 8

    @property
    def mesh_plan(self) -> str:
        """Compact layout descriptor, e.g. ``"dp1.cfg2.sp4"`` (JAX
        ``DistriConfig.mesh_plan``): part of the serve layer's executor
        cache key, since two configs at one resolution on different
        layouts build different programs."""
        cfg_dim = self.group_size // self.n_device_per_batch
        return f"dp{self.dp_degree}.cfg{cfg_dim}.sp{self.n_device_per_batch}"


def _world_and_rank() -> Tuple[int, int]:
    """(world size, rank) of the initialised default process group; (1, 0)
    without one.  A process that torchrun started as one of several ranks
    (``WORLD_SIZE`` > 1) without a process group is refused rather than run
    alone."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise RuntimeError(
            f"WORLD_SIZE={world} but no process group is initialised: call "
            "torch.distributed.init_process_group (nccl for one card a rank, "
            "gloo on the CPU or for ranks that share a card) before building "
            "a DistriConfig; the library never picks a backend"
        )
    return 1, 0


# ---------------------------------------------------------------------------
# The serve layer's configuration (serve/), field for field the JAX
# package's, so that the two compare.  The AOT store's block, whose
# subsystem is not ported yet, validates as there; `InferenceServer`
# refuses to run with it switched on, naming the step of ROADMAP item 16
# that brings it.
# ---------------------------------------------------------------------------

# Default resolution bucket table for the serve layer: the SDXL training
# resolutions ladder up to the repo's benchmarked 2048px high-res point.
DEFAULT_BUCKETS = (
    (512, 512),
    (768, 768),
    (1024, 1024),
    (1024, 2048),
    (2048, 1024),
    (2048, 2048),
)


@dataclasses.dataclass
class ObservabilityConfig:
    """Observability knobs for the serve layer (utils/trace.py +
    utils/metrics.py; docs/OBSERVABILITY.md); lives beside ServeConfig so
    one module owns every run-shaping knob.

    * ``trace`` — request-scoped tracing on/off.  Off (the default) the
      request path executes no tracing code at all (`InferenceServer`
      holds no Tracer); on, every request records its whole life as
      spans exportable via ``server.tracer.export(path)`` /
      ``server.dump_observability(dir)`` as Perfetto-loadable JSON.
    * ``trace_capacity`` — ring bound on retained trace records (oldest
      dropped first, drop count reported): bounded memory no matter how
      long the service runs, same convention as `RingLog`.
    * ``metrics_port`` — when not None, `server.start()` serves the
      unified `MetricsRegistry` over stdlib HTTP on this port
      (``/metrics`` Prometheus text, ``/metrics.json``, ``/healthz``);
      0 binds an ephemeral port (read ``server.metrics_endpoint.port``).
    * ``metrics_host`` — bind address for that endpoint.  Loopback by
      default (a metrics plane should not be world-readable by
      accident); set "0.0.0.0" for containerized deployments whose
      scraper lives outside the host.
    * ``slo_window`` — ring size of the per-SLO-class rolling p50/p99
      windows (`RollingQuantile`) — the signal ROADMAP item 3's
      closed-loop controller reads via ``server.slo_snapshot()``.
    * ``slo_max_age_s`` — maximum age of a sample in those windows
      (server clock).  Without it the windows are time-blind: completions
      from minutes ago keep steering the SLO controller long after the
      load that produced them is gone — an idle server would pin its old
      p99 forever.  Samples older than this are excluded from every
      quantile/snapshot read (the ring still holds them; they simply stop
      counting).  None disables aging.
    """

    trace: bool = False
    trace_capacity: int = 8192
    metrics_port: Optional[int] = None
    metrics_host: str = "127.0.0.1"
    slo_window: int = 512
    slo_max_age_s: Optional[float] = 300.0

    def __post_init__(self) -> None:
        if self.trace_capacity < 1:
            raise ValueError(
                f"trace_capacity must be >= 1, got {self.trace_capacity}"
            )
        if self.metrics_port is not None and not (
                0 <= int(self.metrics_port) <= 65535):
            raise ValueError(
                f"metrics_port must be in [0, 65535], got {self.metrics_port}"
            )
        if not self.metrics_host:
            raise ValueError("metrics_host must be a non-empty bind address")
        if self.slo_window < 1:
            raise ValueError(
                f"slo_window must be >= 1, got {self.slo_window}"
            )
        if self.slo_max_age_s is not None and self.slo_max_age_s <= 0:
            raise ValueError(
                f"slo_max_age_s must be > 0 or None, got {self.slo_max_age_s}"
            )


@dataclasses.dataclass
class StepBatchConfig:
    """Step-level continuous batching (serve/stepbatch.py `StepBatcher`);
    lives beside ServeConfig so one module owns every run-shaping knob.

    With ``enabled``, the server's denoise loop becomes a SLOT POOL of
    per-request (latent, PRNG, step-index, timestep-schedule) state:
    between any two denoise steps the scheduler admits queued requests
    into free slots, retires finished ones, reorders the step cohort by
    deadline slack (EDF over remaining-steps x calibrated per-step
    service), and can preempt the slackest running request mid-denoise —
    its slot state parks and later resumes bit-identically.  Executors
    run step-granular (``ExecKey.exec_mode="step"``, compile-distinct
    from the fused loop).  Mutually exclusive with ``pipeline_stages``
    (the staged pipeline owns whole batches; the slot pool owns steps)
    and with pipefusion buckets (no host-driven per-step loop exists
    there).

    Knobs:
      * ``slots`` — slot-pool capacity: how many requests hold denoise
        state (latents + patch carry) resident at once.  The HBM analog
        of ``max_inflight_batches``.
      * ``step_width`` — max slots advanced per scheduling round (0 =
        all occupied).  Below ``slots`` it turns EDF from an admission
        policy into true per-round step reordering: the cohort is the
        ``step_width`` tightest-slack slots.
      * ``preview_interval`` — every K steps an occupied slot emits a
        cheap downsampled-latent preview through the request's
        ``on_progress`` callback (0 disables).  Previews are host-side
        (no new compiled program) and traced as their own span.
      * ``preview_size`` — max edge length of the preview image (the
        latent decode is downsampled to at most this).
      * ``allow_preemption`` — let an arriving request that would miss
        its deadline park the occupied slot with the MOST deadline
        slack (state resumes bit-identically when a slot frees).
      * ``preempt_margin_s`` — a victim is only parked when its own
        slack exceeds the newcomer's shortfall by this margin, so
        preemption never trades one miss for another.
      * ``step_service_prior_s`` — per-step service-time estimate used
        for EDF slack until measured steps calibrate it (the controller's
        calibrated estimate takes over when the controller is on).
      * ``export_carries`` — on server stop/drain, serialize each
        resident request's denoise carry (serve/migration.py) and fail
        its future with `CarryExportedError` carrying the snapshot, so
        the fleet router can migrate the request to a healthy replica
        and resume at the SAME step instead of re-running from step 0.
        Off, stop falls back to the plain `ServerClosedError` path
        (every completed step is wasted and re-executed on retry).
      * ``pack_align`` — when ``step_width`` truncates the cohort, fill
        it with slots that share the EDF head's compiled step signature
        (same phase / patch-state stage / shallow flag — the grouping
        the executor packs into ONE dispatch) before the rest, so the
        width the round pays for lands in the fewest compiled calls.
        The tightest-slack request always runs first regardless; off,
        the cohort is the plain ``step_width`` tightest slots.
    """

    enabled: bool = False
    slots: int = 8
    step_width: int = 0
    preview_interval: int = 0
    preview_size: int = 64
    allow_preemption: bool = True
    preempt_margin_s: float = 0.0
    step_service_prior_s: float = 0.01
    export_carries: bool = True
    pack_align: bool = True

    def __post_init__(self) -> None:
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.step_width < 0:
            raise ValueError(
                f"step_width must be >= 0 (0 = all occupied), got "
                f"{self.step_width}"
            )
        if self.preview_interval < 0:
            raise ValueError(
                f"preview_interval must be >= 0 (0 disables), got "
                f"{self.preview_interval}"
            )
        if self.preview_size < 1:
            raise ValueError(
                f"preview_size must be >= 1, got {self.preview_size}"
            )
        if self.preempt_margin_s < 0:
            raise ValueError(
                f"preempt_margin_s must be >= 0, got {self.preempt_margin_s}"
            )
        if self.step_service_prior_s <= 0:
            raise ValueError(
                "step_service_prior_s must be > 0, got "
                f"{self.step_service_prior_s}"
            )


@dataclasses.dataclass
class ResilienceConfig:
    """Failure-handling policy for the serve layer (serve/resilience.py);
    lives beside ServeConfig so one module owns every run-shaping knob.

    Retry/backoff:
      * ``max_retries`` — extra attempts per batch dispatch beyond the
        first (0 disables in-server retries).
      * ``retry_budget`` — GLOBAL retry token bucket across all requests;
        when a correlated failure storm empties it, failures surface
        immediately instead of amplifying load.
        ``retry_budget_refill_per_s`` trickles tokens back (up to the
        bucket size) so routine transient blips over days of uptime never
        permanently strip a long-lived server of retries; 0 makes the
        budget a strict lifetime cap.
      * ``backoff_*`` — exponential schedule between attempts:
        ``min(base * multiplier**n, max)`` with ± ``jitter`` fraction of
        seeded randomness (``seed``).

    Circuit breaking (per compiled-executor key):
      * ``breaker_failure_threshold`` consecutive TERMINAL dispatch
        failures (a batch whose retries were exhausted, a fatal error, a
        contract violation — never an individual retried attempt) trip
        the key's breaker OPEN; requests for it shed fast with
        `CircuitOpenError` (503-style) instead of burning queue time.
      * ``breaker_cooldown_s`` later the breaker goes HALF_OPEN and lets
        one probe batch through; success closes it, failure re-opens.

    Watchdog:
      * ``watchdog_timeout_s`` — wall-time bound on one batch execution;
        a hung batch fails with `WatchdogTimeoutError` (and is retried)
        while the scheduler thread keeps serving.  0 disables.

    Degradation ladder (OOM / compile failure, serve/resilience.py):
      * ``allow_batch_split`` — halve an OOM'd coalesced batch and retry
        the halves (bit-identical outputs: per-request seeded latents).
      * ``allow_step_cache_off`` — recompile the bucket without the
        temporal step-cache cadence.
      * ``allow_stepwise_fallback`` — swap the fused scan for the
        host-driven stepwise loop (same numerics, far smaller program).
      * ``allow_bucket_fallback`` — serve at the next smaller bucket;
        OFF by default because it changes the output-resolution contract.
      * ``max_degradations`` — cap on sticky per-key rungs.
    """

    max_retries: int = 2
    retry_budget: int = 10_000
    retry_budget_refill_per_s: float = 1.0
    backoff_base_s: float = 0.05
    backoff_multiplier: float = 2.0
    backoff_max_s: float = 2.0
    backoff_jitter: float = 0.1
    breaker_failure_threshold: int = 3
    breaker_cooldown_s: float = 5.0
    watchdog_timeout_s: float = 120.0
    max_degradations: int = 3
    # LRU bound on per-key resilience state (breakers, degradation rungs):
    # ExecKey space is request-controlled, so tracked keys — and the
    # health payload serializing them — must not grow one entry per
    # distinct key ever seen.  Eviction prefers closed/undegraded state.
    max_tracked_keys: int = 256
    allow_batch_split: bool = True
    # staged servers only (ServeConfig.pipeline_stages): let the ladder
    # stop pipelining an OOM-ing key's batches — overlap holds up to
    # max_inflight_batches of residency, the cheapest HBM to give back,
    # and the rung changes neither the program nor the numerics
    allow_staging_off: bool = True
    allow_step_cache_off: bool = True
    # PipeFusion keys only (ExecKey.parallelism="pipefusion"): on OOM or
    # compile failure, rebuild the key as displaced patch parallelism
    # (parallelism="patch", pipe_patches dropped) — the degraded key is
    # EXACTLY the key a patch-parallel bucket would use, so the rebuild is
    # bit-identical to a fresh patch executor for the same bucket.  This
    # replaces stepwise_fallback for pipefusion keys (the fused tick
    # schedule has no host-driven stepwise loop to fall back to; the
    # stepwise rung never applies to them).  ON by default: the
    # alternative for a failing pipefusion key is no program-level rung at
    # all.  Outputs change only as much as the two parallelization
    # strategies differ (both are tolerance-pinned against the same
    # oracles).
    allow_pipeline_off: bool = True
    allow_stepwise_fallback: bool = True
    # OOM/compile ladder rung below stepwise: rebuild the key with int8
    # quantized weights (ExecKey.weight_quant="int8") — roughly halves the
    # executor's weight HBM, the biggest single give-back on the ladder.
    # OFF by default because, unlike the rungs above it, outputs change
    # (within the pinned parity tolerances, docs/PERF.md "Quantized
    # weights"); opt in like bucket_fallback when availability under OOM
    # outranks bit-stability.
    allow_weight_quant_on: bool = False
    allow_bucket_fallback: bool = False
    last_errors_capacity: int = 16
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.retry_budget < 0:
            raise ValueError(
                f"retry_budget must be >= 0, got {self.retry_budget}"
            )
        if self.retry_budget_refill_per_s < 0:
            raise ValueError(
                "retry_budget_refill_per_s must be >= 0, got "
                f"{self.retry_budget_refill_per_s}"
            )
        if self.backoff_base_s < 0 or self.backoff_max_s < self.backoff_base_s:
            raise ValueError(
                "need 0 <= backoff_base_s <= backoff_max_s, got "
                f"base={self.backoff_base_s}, max={self.backoff_max_s}"
            )
        if self.backoff_multiplier < 1.0:
            raise ValueError(
                f"backoff_multiplier must be >= 1, got {self.backoff_multiplier}"
            )
        if not (0.0 <= self.backoff_jitter < 1.0):
            raise ValueError(
                f"backoff_jitter must be in [0, 1), got {self.backoff_jitter}"
            )
        if self.breaker_failure_threshold < 1:
            raise ValueError(
                "breaker_failure_threshold must be >= 1, got "
                f"{self.breaker_failure_threshold}"
            )
        if self.breaker_cooldown_s < 0:
            raise ValueError(
                f"breaker_cooldown_s must be >= 0, got {self.breaker_cooldown_s}"
            )
        if self.max_degradations < 0:
            raise ValueError(
                f"max_degradations must be >= 0, got {self.max_degradations}"
            )
        if self.max_tracked_keys < 1:
            raise ValueError(
                f"max_tracked_keys must be >= 1, got {self.max_tracked_keys}"
            )
        if self.last_errors_capacity < 1:
            raise ValueError(
                "last_errors_capacity must be >= 1, got "
                f"{self.last_errors_capacity}"
            )


@dataclasses.dataclass
class ControllerConfig:
    """Closed-loop SLO controller policy (serve/controller.py); lives
    beside ServeConfig so one module owns every run-shaping knob.

    The controller walks an ordered *tier table* over the quality/cost
    lattice per SLO class — full quality first, then progressively
    cheaper compiled programs (step cache, wire compression, PCPP partial
    refresh, reduced steps), with admission control past the last tier —
    and dispatches each batch at the least-degraded tier whose PREDICTED
    latency holds the class's p99 target under the current queue depth
    and rolling windows (``server.slo_snapshot()``).  All decisions run
    on the injected server clock, so replayed load produces identical
    tier walks.

    Knobs:
      * ``enabled`` — off (default) keeps today's behavior exactly: no
        controller object is built, no per-dispatch work added.
      * ``slo_p99_s`` — {slo_class: p99 target seconds}.  Classes absent
        from the map use the ``"default"`` entry (one is required).
      * ``tiers`` — the tier table (serve/controller.py TierSpec list);
        () uses the built-in DEFAULT_TIERS.  Validated: unique names,
        strictly decreasing predicted-cost multipliers, first tier cost
        1.0 (the identity/full tier).
      * ``escalate_cooldown_s`` / ``retract_cooldown_s`` — minimum time
        between tier moves per class, one rung per move (the hysteresis
        that keeps a boundary load from flapping).  Retraction (back
        toward full quality) additionally requires the richer tier's
        predicted latency to hold with ``retract_margin`` headroom.
      * ``min_samples`` — observed-p99 breach checks wait for this many
        live window samples (prediction steers from the first dispatch).
      * ``service_prior_s`` — per-batch service-time estimate used until
        real completions calibrate it (``service_window`` ring).
      * ``encode_share`` — fraction of a batch's service time spent in
        text-encode: with a prompt cache attached, predicted service
        scales by ``1 - encode_share * hit_rate`` (a cache hit is a
        cheaper tier input).
    """

    enabled: bool = False
    slo_p99_s: Any = dataclasses.field(
        default_factory=lambda: {"default": 2.0}
    )
    tiers: Sequence[Any] = ()
    escalate_cooldown_s: float = 0.25
    retract_cooldown_s: float = 1.0
    retract_margin: float = 0.6
    min_samples: int = 4
    service_prior_s: float = 0.05
    service_window: int = 32
    encode_share: float = 0.0

    def __post_init__(self) -> None:
        slo = dict(self.slo_p99_s or {})
        if "default" not in slo:
            raise ValueError(
                "slo_p99_s needs a 'default' entry — classes absent from "
                "the map fall back to it"
            )
        for cls, target in slo.items():
            if float(target) <= 0:
                raise ValueError(
                    f"slo_p99_s[{cls!r}] must be > 0, got {target}"
                )
        self.slo_p99_s = {str(c): float(t) for c, t in slo.items()}
        if self.escalate_cooldown_s < 0 or self.retract_cooldown_s < 0:
            raise ValueError(
                "cooldowns must be >= 0, got escalate="
                f"{self.escalate_cooldown_s}, retract="
                f"{self.retract_cooldown_s}"
            )
        if not (0.0 < self.retract_margin <= 1.0):
            raise ValueError(
                f"retract_margin must be in (0, 1], got {self.retract_margin}"
            )
        if self.min_samples < 1:
            raise ValueError(
                f"min_samples must be >= 1, got {self.min_samples}"
            )
        if self.service_prior_s <= 0:
            raise ValueError(
                f"service_prior_s must be > 0, got {self.service_prior_s}"
            )
        if self.service_window < 1:
            raise ValueError(
                f"service_window must be >= 1, got {self.service_window}"
            )
        if not (0.0 <= self.encode_share < 1.0):
            raise ValueError(
                f"encode_share must be in [0, 1), got {self.encode_share}"
            )
        # Lazy import, same convention as BucketTable below: the serve
        # package imports this module at load time.  Normalization owns
        # the tier-table invariants (ordering, knob validity) in ONE place.
        from ..serve.controller import normalize_tier_table

        self.tiers = normalize_tier_table(self.tiers)


@dataclasses.dataclass
class AotCacheConfig:
    """Persistent AOT executable store (serve/aotcache.py): compiled
    denoise programs serialized to a content-addressed on-disk cache so
    a fresh replica warms from deserialized executables in seconds
    instead of paying the full XLA compile campaign (the elastic-
    autoscale gate, ROADMAP item 2).

    * ``dir`` — store directory; None (default) disables the store
      entirely.  Replicas sharing a config share the directory, which
      is the point: a scale-up replica warms from an earlier replica's
      compiles.
    * ``max_bytes`` — on-disk byte budget; least-recently-LOADED
      entries evict first once a save pushes the total over.
    * ``readonly`` — CI/canary mode: loads serve, saves count a skip
      and write nothing (a test run never grows or reorders the shared
      store).
    """

    dir: Optional[str] = None
    max_bytes: int = 2 * 1024**3
    readonly: bool = False

    def __post_init__(self) -> None:
        if self.max_bytes < 1:
            raise ValueError(
                f"aot_cache.max_bytes must be >= 1, got {self.max_bytes}"
            )


@dataclasses.dataclass


@dataclasses.dataclass
class AutoscaleConfig:
    """Elastic replica-pool autoscaling (serve/autoscale.py
    `Autoscaler`, driven from the fleet housekeeping tick).

    Pressure is the fleet's step-granular utilization: (occupied step
    slots + queued/parked work, weighted by remaining steps) over the
    SERVING replicas' slot capacity — the occupancy model the SLO
    controller reads.  Sustained pressure above ``pressure_high`` for
    ``up_sustain_s`` starts one stopped replica; sustained pressure
    below ``pressure_low`` for ``down_sustain_s`` drains one (bounded by
    ``drain_deadline_s`` — the drain rides the carry-migration path, so
    scale-down discards no steps).
    ``cooldown_s`` separates consecutive scale actions so one load
    swing never slams the pool between bounds; ``min_replicas`` /
    ``max_replicas`` (0 = every configured slot) bound the pool.
    """

    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 0
    pressure_high: float = 0.8
    pressure_low: float = 0.25
    up_sustain_s: float = 0.5
    down_sustain_s: float = 5.0
    cooldown_s: float = 5.0
    drain_deadline_s: float = 30.0

    def __post_init__(self) -> None:
        if self.min_replicas < 1:
            raise ValueError(
                f"autoscale.min_replicas must be >= 1, got "
                f"{self.min_replicas}"
            )
        if self.max_replicas < 0:
            raise ValueError(
                "autoscale.max_replicas must be >= 0 (0 = all configured "
                f"replicas), got {self.max_replicas}"
            )
        if self.max_replicas and self.max_replicas < self.min_replicas:
            raise ValueError(
                f"autoscale.max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})"
            )
        if self.pressure_high <= 0:
            raise ValueError(
                f"autoscale.pressure_high must be > 0, got "
                f"{self.pressure_high}"
            )
        if not (0.0 <= self.pressure_low < self.pressure_high):
            raise ValueError(
                "autoscale.pressure_low must be in [0, pressure_high), "
                f"got {self.pressure_low} (high={self.pressure_high})"
            )
        for name in ("up_sustain_s", "down_sustain_s", "cooldown_s"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"autoscale.{name} must be >= 0, got "
                    f"{getattr(self, name)}"
                )
        if self.drain_deadline_s <= 0:
            raise ValueError(
                "autoscale.drain_deadline_s must be > 0, got "
                f"{self.drain_deadline_s}"
            )


@dataclasses.dataclass
class FleetConfig:
    """Multi-replica fleet policy (serve/fleet.py `FleetRouter`); lives
    beside ServeConfig so one module owns every run-shaping knob.

    Routing and health scoring:
      * Each replica is scored in [0, 1] from its own serve signals
        (`Replica.health_score`): open-circuit share, SLO-controller tier
        depth, and rolling p99 vs ``p99_ref_s`` (None skips the latency
        term).  The router dispatches to the serving replica maximizing
        ``score * capacity_weight / (1 + queue_depth + inflight)`` —
        weighted least-degraded, so mixed-capability replicas
        (``Replica.capacity_weight``) are held to one SLO by steering
        load toward spare healthy capacity.

    Failover:
      * A replica's TERMINAL dispatch failure (retries exhausted,
        circuit open, watchdog, replica killed) re-dispatches the request
        onto a different replica, at most ``max_failovers`` times per
        request, each drawing from the fleet-wide `RetryBudget`
        (``failover_budget`` + ``failover_budget_refill_per_s`` — the
        same storm-bounding token bucket the in-server retry loop uses).
        A request is only ever re-dispatched after its prior replica's
        outcome is terminal, so its result is delivered exactly once and
        a dispatch that failed before completing never runs twice (a
        watchdog-ABANDONED dispatch may still finish in the background
        with its result discarded — the single-server watchdog caveat,
        unchanged).  When no replica can take the request right now it
        is PARKED in the router and re-dispatched from the housekeeping
        tick.

    Fleet-level graceful degradation (the per-key `CircuitBreaker`
    semantics lifted one level up):
      * ``health_floor`` — a serving replica whose score reaches this
        floor is auto-DRAINED (stops admitting, finishes in-flight);
        so is one that accumulates ``drain_failure_threshold``
        consecutive terminal failures.
      * ``probe_cooldown_s`` later the drained replica is probed
        half-open style: exactly one live request routes to it; success
        returns it to serving, failure re-drains and re-arms the
        cooldown.
      * ``auto_restart`` (+ ``restart_cooldown_s``) — a replica whose
        server STOPPED (e.g. the ``"replica"`` fault site's kill) is
        rebuilt and re-warmed in the background instead of probed.

    ``tick_s`` is the housekeeping cadence (auto-drain checks, probe
    arming, parked re-dispatch); 0 disables the tick thread — tests
    drive `FleetRouter.tick()` manually on an injected clock.
    """

    health_floor: float = 0.05
    drain_failure_threshold: int = 3
    probe_cooldown_s: float = 5.0
    max_failovers: int = 3
    failover_budget: int = 10_000
    failover_budget_refill_per_s: float = 1.0
    tick_s: float = 0.05
    p99_ref_s: Optional[float] = None
    auto_restart: bool = False
    restart_cooldown_s: float = 10.0
    # Elastic pool sizing between min/max bounds from the step-granular
    # occupancy model, riding drain/warm-up + carry migration so scale
    # events drop no steps — see AutoscaleConfig above.  Off by default.
    autoscale: "AutoscaleConfig" = dataclasses.field(
        default_factory=AutoscaleConfig
    )

    def __post_init__(self) -> None:
        if not isinstance(self.autoscale, AutoscaleConfig):
            raise ValueError(
                "autoscale must be an AutoscaleConfig, got "
                f"{type(self.autoscale).__name__}"
            )
        if not (0.0 <= self.health_floor < 1.0):
            raise ValueError(
                f"health_floor must be in [0, 1), got {self.health_floor}"
            )
        if self.drain_failure_threshold < 1:
            raise ValueError(
                "drain_failure_threshold must be >= 1, got "
                f"{self.drain_failure_threshold}"
            )
        if self.probe_cooldown_s < 0:
            raise ValueError(
                f"probe_cooldown_s must be >= 0, got {self.probe_cooldown_s}"
            )
        if self.max_failovers < 0:
            raise ValueError(
                f"max_failovers must be >= 0, got {self.max_failovers}"
            )
        if self.failover_budget < 0:
            raise ValueError(
                f"failover_budget must be >= 0, got {self.failover_budget}"
            )
        if self.failover_budget_refill_per_s < 0:
            raise ValueError(
                "failover_budget_refill_per_s must be >= 0, got "
                f"{self.failover_budget_refill_per_s}"
            )
        if self.tick_s < 0:
            raise ValueError(f"tick_s must be >= 0, got {self.tick_s}")
        if self.p99_ref_s is not None and self.p99_ref_s <= 0:
            raise ValueError(
                f"p99_ref_s must be > 0 or None, got {self.p99_ref_s}"
            )
        if self.restart_cooldown_s < 0:
            raise ValueError(
                "restart_cooldown_s must be >= 0, got "
                f"{self.restart_cooldown_s}"
            )


@dataclasses.dataclass
class TenantConfig:
    """One tenant's share of the serve plane (serve/tenancy.py).

    * ``weight`` — relative long-run share of scheduler service under
      contention: the deficit-round-robin queue credits each tenant
      ``drr_quantum * weight`` denoise steps per round, so a weight-3
      tenant sustains 3x a weight-1 tenant's step throughput when both
      are backlogged.  Idle share is never reserved — a lone tenant gets
      the whole scheduler regardless of weight.
    * ``rate_rps`` / ``burst`` — token-bucket admission quota: sustained
      requests/second and the bucket capacity (how large an instant
      burst admits before the rate limit bites).  ``rate_rps=0`` means
      unlimited (no bucket); ``burst=0`` with a positive rate defaults
      the capacity to ``max(1, rate_rps)``.
    """

    name: str
    weight: float = 1.0
    rate_rps: float = 0.0
    burst: float = 0.0

    def __post_init__(self) -> None:
        if not isinstance(self.name, str) or not self.name:
            raise ValueError(
                f"tenant name must be a non-empty string, got {self.name!r}"
            )
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, got {self.weight}"
            )
        if self.rate_rps < 0:
            raise ValueError(
                f"tenant {self.name!r}: rate_rps must be >= 0, got "
                f"{self.rate_rps}"
            )
        if self.burst < 0:
            raise ValueError(
                f"tenant {self.name!r}: burst must be >= 0, got {self.burst}"
            )
        if self.rate_rps > 0 and self.burst == 0:
            self.burst = max(1.0, float(self.rate_rps))


@dataclasses.dataclass
class GatewayConfig:
    """HTTP/SSE gateway + multi-tenancy block (serve/gateway.py,
    serve/tenancy.py; docs/SERVING.md "Gateway & multi-tenancy").

    * ``port`` — gateway listen port (0 = ephemeral); None means no
      gateway is auto-started (the tenancy knobs still apply to
      in-process submits).
    * ``tenants`` — the tenant table.  Empty (default) disables tenant
      accounting entirely: the queue stays a pure EDF queue.
      Non-empty activates per-tenant token buckets + weighted DRR; a
      tenant named ``default_tenant`` is implicitly added (weight 1,
      unlimited rate) if absent, so untagged requests keep working.
    * ``drr_quantum`` — denoise-step credit added to a backlogged
      tenant's deficit per round-robin pass (scaled by its weight).
      Larger quanta batch a tenant's turns together (fewer executor
      key switches); smaller quanta interleave tenants more finely.
    * ``max_events`` — per-request SSE buffer depth; a slow consumer's
      preview frames drop OLDEST beyond this (counted, never blocking
      the scheduler thread).  Terminal events are never dropped.
    * ``max_threads`` — bound on concurrent gateway handler threads
      (excess connections wait in the listen backlog).
    * ``max_requests`` — retention bound on the gateway's connection
      table; oldest FINISHED entries are evicted beyond it (pending
      entries are never evicted).
    """

    port: Optional[int] = None
    host: str = "127.0.0.1"
    tenants: Sequence["TenantConfig"] = ()
    default_tenant: str = "default"
    drr_quantum: float = 8.0
    max_events: int = 64
    max_threads: int = 8
    max_requests: int = 1024

    def __post_init__(self) -> None:
        if self.port is not None and int(self.port) < 0:
            raise ValueError(f"gateway port must be >= 0, got {self.port}")
        seen = set()
        for t in self.tenants:
            if not isinstance(t, TenantConfig):
                raise ValueError(
                    f"tenants entries must be TenantConfig, got "
                    f"{type(t).__name__}"
                )
            if t.name in seen:
                raise ValueError(f"duplicate tenant name {t.name!r}")
            seen.add(t.name)
        self.tenants = tuple(self.tenants)
        if not self.default_tenant:
            raise ValueError("default_tenant must be non-empty")
        if self.drr_quantum <= 0:
            raise ValueError(
                f"drr_quantum must be > 0, got {self.drr_quantum}"
            )
        if self.max_events < 2:
            raise ValueError(
                f"max_events must be >= 2 (room for one preview plus the "
                f"terminal event), got {self.max_events}"
            )
        if self.max_threads < 1:
            raise ValueError(
                f"max_threads must be >= 1, got {self.max_threads}"
            )
        if self.max_requests < 1:
            raise ValueError(
                f"max_requests must be >= 1, got {self.max_requests}"
            )


@dataclasses.dataclass
class ServeConfig:
    """Configuration block for ``distrifuser_tpu.serve`` (the long-lived
    inference service).  Kept here, beside DistriConfig, so one module owns
    every run-shaping knob; the serve subsystem never invents defaults.

    Admission control:
      * ``max_queue_depth`` — bound on requests waiting for a batch slot;
        submissions beyond it are rejected 429-style (QueueFullError), the
        backpressure signal for upstream load balancers.
      * ``default_ttl_s`` — per-request deadline when the caller gives none;
        a request that waits past its deadline is *rejected*, never executed
        (late work is wasted mesh time).

    Micro-batching:
      * ``max_batch_size`` — cap on requests coalesced into one invocation.
      * ``batch_window_s`` — how long the batcher lingers for compatible
        followers after the first request of a batch arrives.  0 disables
        coalescing-by-wait (batches still form from a backlog).

    Shape bucketing / compiled cache:
      * ``buckets`` — (height, width) table; a request snaps to the smallest
        bucket covering it, so the compiled program for a bucket is reused
        across nearby resolutions.
      * ``cache_capacity`` — LRU bound on resident compiled executables.
      * ``warmup_buckets`` — (height, width[, steps]) tuples compiled at
        startup so steady-state traffic never pays a request-path retrace;
        ``warmup_cfg`` is the guidance mode they compile for (match it to
        your traffic — a CFG-off service warming cfg=True executors buys
        nothing and burns an LRU slot).
    """

    max_queue_depth: int = 64
    default_ttl_s: float = 120.0
    max_batch_size: int = 8
    batch_window_s: float = 0.02
    buckets: Sequence[Sequence[int]] = DEFAULT_BUCKETS
    cache_capacity: int = 8
    warmup_buckets: Sequence[Sequence[int]] = ()
    warmup_cfg: bool = True
    default_steps: int = 50
    # Service-wide step-cache cadence (DistriConfig.step_cache_* semantics):
    # threaded into every ExecKey so a cadence change invalidates compiled
    # executors, and surfaced as the shallow-step share in serve metrics.
    # The pipeline build function behind executor_factory must construct its
    # DistriConfig with the same knobs.
    step_cache_interval: int = 1
    step_cache_depth: int = 0
    # Service-wide stale-refresh compression (DistriConfig.comm_compress
    # semantics): threaded into every ExecKey — a mode change invalidates
    # compiled executors, the same contract as the cadence knobs.  The
    # pipeline build function behind executor_factory must construct its
    # DistriConfig with the same mode.
    comm_compress: str = "none"
    # Service-wide DENOISER weight quantization (DistriConfig.weight_quant
    # semantics): threaded into every ExecKey — full-precision and
    # quantized executables are different compiled programs and coexist in
    # one fleet under distinct keys.  The pipeline build function behind
    # executor_factory must construct its DistriConfig with the same mode
    # (serve.executors.apply_key_policy force-quantizes build functions that
    # ignore the field, so ladder-degraded keys work against any build function).
    # The aux-model sub-knob (weight_quant_aux) stays a build function decision:
    # it is fixed per build function, so it needs no per-key identity.
    weight_quant: str = "none"
    # Service-wide quantized-COMPUTE policy (DistriConfig.quant_compute
    # semantics): threaded into every ExecKey — storage-only ("off") and
    # compute-routed ("auto"/"dot"/"pallas") programs trace different
    # matmul paths, so they are distinct executables.  "auto" (default)
    # means the tier ladder's int8 rungs and the fleet inherit the
    # low-precision execution path with no further serve-layer changes.
    quant_compute: str = "auto"
    # Service-wide PCPP partial-refresh fraction (DistriConfig.
    # refresh_fraction semantics): threaded into every ExecKey — the
    # strided refresh schedule is traced into the program, so a fraction
    # change is a different executable.  1.0 (default) is the exact
    # protocol; the SLO controller's partial_refresh tier overrides this
    # per dispatch.  The pipeline build function behind executor_factory must
    # construct its DistriConfig from key.refresh_fraction
    # (serve.executors.apply_key_policy forces the field pre-prepare).
    refresh_fraction: float = 1.0
    # Service-wide parallelization strategy (DistriConfig.parallelism
    # semantics, "patch" or "pipefusion"): threaded into every ExecKey —
    # patch-parallel and pipeline-parallel executors are different XLA
    # programs coexisting in one fleet under distinct keys.  The build function
    # behind executor_factory must construct its DistriConfig from
    # key.parallelism (serve.executors.apply_key_policy rejects a
    # mismatch with a typed error so the ladder can retract).
    parallelism: str = "patch"
    # With parallelism="pipefusion": DistriConfig.pipe_patches for the
    # built pipelines (None = one patch per stage), a compile-identity
    # field on ExecKey like the cadence knobs.
    pipe_patches: Optional[int] = None
    # Per-resolution-bucket strategy overrides: {(height, width):
    # "patch" | "pipefusion"} keyed by BUCKET (post-snap) resolution.
    # PipeFusion wins at high resolution and deep meshes (docs/PERF.md
    # "When pipeline beats displaced patches"); the map lets one fleet
    # serve small buckets patch-parallel and big buckets
    # pipeline-parallel simultaneously.  Buckets absent from the map use
    # the service-wide ``parallelism``.
    bucket_parallelism: Any = dataclasses.field(default_factory=dict)
    # Staged pipelining (serve/staging.py, docs/SERVING.md "Staged
    # pipelining"): overlap text-encode, denoise, and VAE-decode across
    # micro-batches so batch k+1 encodes and batch k-1 decodes in the
    # shadow of batch k's denoise.  Off by default: staged and monolithic
    # execution are bit-identical per request, but staging holds up to
    # ``max_inflight_batches`` batches of device buffers resident (the
    # HBM cap) and trades the in-line retry loop for throughput (a stage
    # failure is one terminal dispatch failure; sticky degradations —
    # including the staging_off rung — handle repeat offenders).
    pipeline_stages: bool = False
    max_inflight_batches: int = 2
    # Step-level continuous batching (serve/stepbatch.py, docs/SERVING.md
    # "Step-level continuous batching"): the denoise loop becomes a slot
    # pool of per-request state — requests join and leave the in-flight
    # denoise BETWEEN STEPS, the cohort reorders by deadline slack (EDF),
    # low-slack arrivals can preempt the slackest slot (park + bit-
    # identical resume), and occupied slots stream cheap latent previews
    # every K steps.  Executors key at ExecKey.exec_mode="step" (compile-
    # distinct).  Off by default; see StepBatchConfig above.  Mutually
    # exclusive with pipeline_stages and with pipefusion parallelism.
    step_batching: "StepBatchConfig" = dataclasses.field(
        default_factory=StepBatchConfig
    )
    # Prompt/embedding LRU cache in front of the text-encode stage
    # (serve/promptcache.py): repeated prompts — the dominant production
    # pattern — skip text-encode entirely.  Keyed by (family, tokenizer
    # hash, prompt chunk); hit rate lands in the MetricsRegistry
    # (serve_prompt_cache) and feeds the SLO controller's predicted
    # service time (ControllerConfig.encode_share).  0 (default) disables.
    prompt_cache_capacity: int = 0
    # Closed-loop SLO controller (serve/controller.py, docs/SERVING.md
    # "Closed-loop SLO control"): load-driven tier selection over the
    # quality/cost lattice per slo_class, with admission control at the
    # extreme.  Off by default — see ControllerConfig above.
    controller: "ControllerConfig" = dataclasses.field(
        default_factory=ControllerConfig
    )
    # Failure handling: retries/backoff, per-key circuit breakers, the
    # execution watchdog, and the graceful-degradation ladder — see
    # ResilienceConfig above and docs/SERVING.md "Failure modes & tuning".
    resilience: ResilienceConfig = dataclasses.field(
        default_factory=ResilienceConfig
    )
    # Tracing + metrics plane: request-scoped spans, the unified
    # MetricsRegistry HTTP endpoint, and the per-SLO-class rolling
    # latency windows — see ObservabilityConfig above and
    # docs/OBSERVABILITY.md.
    observability: ObservabilityConfig = dataclasses.field(
        default_factory=ObservabilityConfig
    )
    # HTTP/SSE gateway + per-tenant fair queuing (serve/gateway.py,
    # serve/tenancy.py): the wire front end over submit(), and the
    # tenant table that turns the request queue into token-bucket +
    # weighted-DRR fair queuing — see GatewayConfig above and
    # docs/SERVING.md "Gateway & multi-tenancy".
    gateway: GatewayConfig = dataclasses.field(default_factory=GatewayConfig)
    # Persistent AOT executable store (serve/aotcache.py): warmup and
    # ladder rebuilds consult it before compiling and populate it on
    # miss, so a fresh replica warms from serialized executables instead
    # of a compile campaign — see AotCacheConfig above and
    # docs/SERVING.md "AOT cache & elastic autoscale".  Disabled unless
    # ``aot_cache.dir`` is set.
    aot_cache: "AotCacheConfig" = dataclasses.field(
        default_factory=AotCacheConfig
    )

    def __post_init__(self) -> None:
        if self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth}"
            )
        if self.max_batch_size < 1:
            raise ValueError(
                f"max_batch_size must be >= 1, got {self.max_batch_size}"
            )
        if self.default_ttl_s <= 0:
            raise ValueError(
                f"default_ttl_s must be > 0, got {self.default_ttl_s}"
            )
        if self.batch_window_s < 0:
            raise ValueError(
                f"batch_window_s must be >= 0, got {self.batch_window_s}"
            )
        if self.cache_capacity < 1:
            raise ValueError(
                f"cache_capacity must be >= 1, got {self.cache_capacity}"
            )
        if self.max_inflight_batches < 1:
            raise ValueError(
                "max_inflight_batches must be >= 1, got "
                f"{self.max_inflight_batches}"
            )
        if self.prompt_cache_capacity < 0:
            raise ValueError(
                "prompt_cache_capacity must be >= 0, got "
                f"{self.prompt_cache_capacity}"
            )
        validate_step_cache_knobs(self.step_cache_interval,
                                  self.step_cache_depth)
        from ..parallel.compress import (
            validate_mode,
            validate_refresh_fraction,
            validate_serve_quant_compute,
            validate_weight_mode,
        )

        validate_mode(self.comm_compress)
        validate_refresh_fraction(self.refresh_fraction)
        validate_weight_mode(self.weight_quant)
        validate_serve_quant_compute(self.quant_compute, self.weight_quant)
        _SERVE_PARALLELISMS = ("patch", "pipefusion")
        if self.parallelism not in _SERVE_PARALLELISMS:
            raise ValueError(
                f"ServeConfig.parallelism must be one of "
                f"{_SERVE_PARALLELISMS}, got {self.parallelism!r}"
            )
        if self.pipe_patches is not None and int(self.pipe_patches) < 1:
            raise ValueError(
                f"pipe_patches must be >= 1, got {self.pipe_patches}"
            )
        norm_bp = {}
        for hw, strat in dict(self.bucket_parallelism or {}).items():
            if strat not in _SERVE_PARALLELISMS:
                raise ValueError(
                    f"bucket_parallelism[{tuple(hw)}] must be one of "
                    f"{_SERVE_PARALLELISMS}, got {strat!r}"
                )
            norm_bp[(int(hw[0]), int(hw[1]))] = strat
        self.bucket_parallelism = norm_bp
        # BucketTable owns bucket validation and the area-major ordering
        # invariant ("smallest covering bucket" scans front-to-back) — one
        # normalization, not a copy here that could drift.  Lazy import:
        # the serve package imports this module at load time.
        from ..serve.batcher import BucketTable

        self.buckets = BucketTable(self.buckets).buckets
        for hw in self.bucket_parallelism:
            if hw not in self.buckets:
                raise ValueError(
                    f"bucket_parallelism key {hw} is not a configured "
                    f"bucket (buckets: {tuple(self.buckets)}) — the map is "
                    "keyed by post-snap bucket resolution"
                )
        warm = []
        for b in self.warmup_buckets:
            if len(b) not in (2, 3):
                raise ValueError(
                    f"warmup bucket {tuple(b)}: expected (h, w) or (h, w, steps)"
                )
            warm.append(tuple(int(x) for x in b))
        self.warmup_buckets = tuple(warm)
        if not isinstance(self.resilience, ResilienceConfig):
            raise ValueError(
                "resilience must be a ResilienceConfig, got "
                f"{type(self.resilience).__name__}"
            )
        if not isinstance(self.controller, ControllerConfig):
            raise ValueError(
                "controller must be a ControllerConfig, got "
                f"{type(self.controller).__name__}"
            )
        if not isinstance(self.step_batching, StepBatchConfig):
            raise ValueError(
                "step_batching must be a StepBatchConfig, got "
                f"{type(self.step_batching).__name__}"
            )
        if self.step_batching.enabled:
            if self.pipeline_stages:
                raise ValueError(
                    "step_batching and pipeline_stages are mutually "
                    "exclusive: the staged pipeline owns whole batches "
                    "while the slot pool owns individual steps — pick one "
                    "dispatch mode per server"
                )
            if (self.parallelism == "pipefusion"
                    or "pipefusion" in set(self.bucket_parallelism.values())):
                raise ValueError(
                    "step_batching requires patch-parallel buckets: the "
                    "PipeFusion tick pipeline has no host-driven per-step "
                    "loop to schedule at step granularity"
                )
        if not isinstance(self.observability, ObservabilityConfig):
            raise ValueError(
                "observability must be an ObservabilityConfig, got "
                f"{type(self.observability).__name__}"
            )
        if not isinstance(self.gateway, GatewayConfig):
            raise ValueError(
                "gateway must be a GatewayConfig, got "
                f"{type(self.gateway).__name__}"
            )
        if not isinstance(self.aot_cache, AotCacheConfig):
            raise ValueError(
                "aot_cache must be an AotCacheConfig, got "
                f"{type(self.aot_cache).__name__}"
            )
