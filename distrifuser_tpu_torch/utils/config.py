"""Run configuration for the PyTorch port.

Counterpart of distrifuser_tpu/utils/config.py:DistriConfig.  Field names
and validation follow the JAX package; the mesh gives way to an explicit
``device``.  This port runs one rank: patch parallelism across ranks
(process groups, NCCL) is ROADMAP queue 1 item 7, so a process launched
as one of several ranks (an initialised process group, or torchrun's
``WORLD_SIZE``) is refused rather than run alone on one card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

from ..parallel.compress import validate_quant_compute, validate_weight_mode
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


@dataclasses.dataclass
class DistriConfig:
    """Run parameters: image size, CFG, sync mode, dtype, weight
    quantization and device.

    ``device`` None means the first CUDA card (raises if there is none);
    ``dtype`` None means bf16 on the card and float32 on the CPU, as the
    JAX package defaults to bf16 on the TPU and float32 on the CPU.

    ``weight_quant`` ("none", "int8", "fp8") holds the denoiser's matmul
    and conv kernels as 1-byte payloads with one float32 scale per output
    channel (models/weights.py ``quantize_params``; the UNet's ``conv_out``
    stays dense); ``weight_quant_aux`` does the same for the text encoders
    and the VAE, which always densify at the consumer.  ``quant_compute``
    says how the denoiser's quantized linears execute (ops/gemm_routing.py):
    "off" densifies them, "auto" picks per shape, "dot" forces the library
    8-bit GEMM and "pallas" the hand-written kernel of ops/quant_matmul.py.
    """

    height: int = 1024
    width: int = 1024
    do_classifier_free_guidance: bool = True
    warmup_steps: int = 4
    mode: str = "corrected_async_gn"
    parallelism: str = "patch"
    dtype: Any = None
    batch_size: int = 1
    weight_quant: str = "none"
    weight_quant_aux: str = "none"
    quant_compute: str = "auto"
    device: Any = None

    def __post_init__(self) -> None:
        if self.mode not in SYNC_MODES:
            raise ValueError(f"mode must be one of {SYNC_MODES}, got {self.mode!r}")
        if self.parallelism not in PARALLELISMS:
            raise ValueError(
                f"parallelism must be one of {PARALLELISMS}, got {self.parallelism!r}"
            )
        if self.height % 8 != 0 or self.width % 8 != 0:
            raise ValueError("height and width must be multiples of 8")
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        validate_weight_mode(self.weight_quant)
        validate_weight_mode(self.weight_quant_aux)
        validate_quant_compute(self.quant_compute, self.weight_quant)
        if self.weight_quant != "none" and self.parallelism == "tensor":
            raise ValueError(
                "weight_quant quantizes whole kernels ahead of the mesh split; "
                "parallelism='tensor' pre-shards its param tree and would "
                "silently densify the payloads; keep weight_quant='none' there"
            )
        world = self.world_size
        if not is_power_of_2(world):
            raise ValueError(f"world size must be a power of 2, got {world}")
        if world != 1:
            raise NotImplementedError(
                f"world size {world}: the PyTorch port runs one rank so far; "
                "multi-rank displaced patch parallelism is ROADMAP queue 1 "
                "item 7"
            )
        self.device = resolve_device(self.device)
        if self.dtype is None:
            self.dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32

    @property
    def world_size(self) -> int:
        """Ranks this process belongs to: the initialised process group's
        size, else torchrun's ``WORLD_SIZE``, else 1."""
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            return torch.distributed.get_world_size()
        return int(os.environ.get("WORLD_SIZE", "1"))

    @property
    def cfg_split(self) -> bool:
        """CFG branches on separate ranks: never at the one rank this port
        runs, so the branches fold into the batch."""
        return False

    @property
    def latent_height(self) -> int:
        return self.height // 8

    @property
    def latent_width(self) -> int:
        return self.width // 8
