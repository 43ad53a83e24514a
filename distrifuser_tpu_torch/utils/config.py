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
  ``reshape(dp, cfg, n)`` order.

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
from typing import Any, Dict, Optional, Tuple

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

# process groups already built, keyed by (default group, world, dp, n) and
# ("usp", default group, world, n, ulysses_degree): every config of a run
# shares them, and every rank builds them in one order
_GROUPS: Dict[Tuple[Any, ...], Tuple[Any, ...]] = {}


def _process_groups(world: int, n: int, rank: int, dp: int = 1):
    """(batch_group, split_group, dp_group) of this rank, after the
    reference's utils.py:84-96 within each of the ``dp`` image groups of
    world / dp consecutive ranks; ``split_group`` is None without the CFG
    split (n is the image group), ``dp_group`` None at dp 1.
    ``dist.new_group`` is collective over the world: every rank creates
    every group, in the same order, including the groups it is not in."""
    key = (dist.group.WORLD, world, dp, n)
    if key not in _GROUPS:
        size = world // dp  # ranks of an image group
        if n == world:
            batch = [dist.group.WORLD]
        else:
            batch = [dist.new_group(list(range(b * n, (b + 1) * n)))
                     for b in range(world // n)]
        split = [None] * (world // n)
        if n < size:  # two branches an image group
            split = [dist.new_group([g * size + s, g * size + s + n])
                     for g in range(dp) for s in range(n)]
        dp_groups = [None] * size
        if dp > 1:
            dp_groups = [dist.new_group(list(range(p, world, size))) for p in range(size)]
        image, place = rank // size, rank % size
        _GROUPS[key] = (batch[rank // n], split[image * n + place % n] if n < size else None,
                        dp_groups[place])
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
    key = ("usp", dist.group.WORLD, world, n, u)
    if key not in _GROUPS:
        u_groups = [dist.new_group([g + ui * r + ri for ui in range(u)])
                    for g in range(0, world, n) for ri in range(r)]
        r_groups = [dist.new_group([g + ui * r + ri for ri in range(r)])
                    for g in range(0, world, n) for ui in range(u)]
        _GROUPS[key] = (u_groups, r_groups)
    u_groups, r_groups = _GROUPS[key]
    g, s = rank // n, rank % n
    return u_groups[g * r + s % r], r_groups[g * u + s // r]


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
