"""PyTorch / CUDA port of distrifuser_tpu for NVIDIA Hopper (H100).

A second package beside the JAX reference: the same module names, PyTorch
inside, and every Pallas TPU kernel on the ported path replaced by a kernel
written by hand for sm_90a (``csrc/``).  It runs single-device SDXL
text-to-image: ``DistriSDXLPipeline`` -> ``DenoiseRunner`` ->
``unet_forward`` -> VAE ``decode``, with all attention through the flash
kernel and, under ``DistriConfig(weight_quant="int8" | "fp8",
quant_compute="pallas")``, every quantized UNet linear through the int8/fp8
GEMM kernel.  Entry points run on the first CUDA card unless given
``device="cpu"``; kernels are built with nvcc at first use, never at import.
"""

from .pipelines import DistriSDXLPipeline, PipelineOutput, SimpleTokenizer
from .utils.config import DistriConfig

__all__ = ["DistriConfig", "DistriSDXLPipeline", "PipelineOutput", "SimpleTokenizer"]
