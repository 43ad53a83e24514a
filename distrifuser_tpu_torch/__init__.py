"""PyTorch / CUDA port of distrifuser_tpu for NVIDIA Hopper (H100).

A second package beside the JAX reference: the same module names, PyTorch
inside, and every Pallas TPU kernel on the ported path replaced by a kernel
written by hand for sm_90a (``csrc/``).  This slice runs single-device SDXL
text-to-image: ``DistriSDXLPipeline`` -> ``DenoiseRunner`` ->
``unet_forward`` -> VAE ``decode``, with all attention through the flash
kernel.  Entry points run on the first CUDA card unless given
``device="cpu"``; kernels are built with nvcc at first use, never at import.
"""

from .pipelines import DistriSDXLPipeline, PipelineOutput, SimpleTokenizer
from .utils.config import DistriConfig

__all__ = ["DistriConfig", "DistriSDXLPipeline", "PipelineOutput", "SimpleTokenizer"]
