"""PyTorch / CUDA port of distrifuser_tpu for NVIDIA Hopper (H100).

A second package beside the JAX reference: the same module names, PyTorch
inside, and every Pallas TPU kernel on the ported path replaced by a kernel
written by hand for sm_90a (``csrc/``).  It runs text-to-image for SDXL
(``DistriSDXLPipeline``), SD 1.x / 2.x (``DistriSDPipeline``), PixArt-α
(``DistriPixArtPipeline``: T5 -> ``DiTDenoiseRunner`` over the DiT of
models/dit.py, "gather" or "ring" layout -> VAE) and SD3
(``DistriSD3Pipeline``: CLIP-L, bigG and T5 -> ``MMDiTDenoiseRunner`` over
the MMDiT of models/mmdit.py, rectified-flow Euler -> VAE) on one card or under
DistriFusion's displaced patch parallelism on n ranks; for the UNet:
pipeline -> ``DenoiseRunner`` (DDIM, Euler or DPM++ 2M) -> ``unet_forward``
(dense, or ``PatchDispatch`` over torch.distributed process groups) -> VAE
``decode``, with all attention through the flash kernel and, under
``DistriConfig(weight_quant="int8" | "fp8", quant_compute="pallas")``,
every quantized UNet linear through the int8/fp8 GEMM kernel.  Pipelines
come from in-memory trees (``from_params``) or a local diffusers snapshot
(``from_pretrained``, read by the pure-Python safetensors reader and CLIP
tokenizer of ``native/``).  Several ranks need a process group that the
caller initialised (torchrun or ``torch.multiprocessing``).  Entry points
run on the card of the rank's local rank unless given ``device="cpu"``;
kernels are built with nvcc at first use, never at import.
"""

from .pipelines import (DistriPixArtPipeline, DistriSD3Pipeline, DistriSDPipeline,
                        DistriSDXLPipeline, PipelineOutput, SimpleTokenizer)
from .utils.config import DistriConfig

__all__ = ["DistriConfig", "DistriPixArtPipeline", "DistriSD3Pipeline",
           "DistriSDPipeline", "DistriSDXLPipeline", "PipelineOutput", "SimpleTokenizer"]
