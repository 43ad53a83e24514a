"""Per-shape routing of quantized-weight matmuls.

Counterpart of distrifuser_tpu/ops/gemm_routing.py (``GemmRoute``,
``GEMM_IMPLS``, ``DOT_MIN_M``, ``resolve``).  ops/linear.py sends every
``QuantizedTensor`` matmul down one of

* ``"dequant"``: densify the kernel and run a dense matmul;
* ``"dot"``: per-token activation quantization, then a library 8-bit GEMM
  (``torch._int_mm`` / ``torch._scaled_mm`` on the card, the plain product
  on the CPU), with the scales applied after it;
* ``"pallas"``: the same quantization, then the hand-written kernel of
  ops/quant_matmul.py with the weight scale applied in its epilogue.  The
  name is the JAX package's; on the card it is the CUDA kernel.

Resolution order in ``resolve`` (strongest wins): a forced leaf policy
(``"dequant"``, or ``"dot"``/``"pallas"`` from DistriConfig.quant_compute),
then the analytic default by the activation's platform: the CPU densifies;
the card runs the 8-bit dot for M >= ``DOT_MIN_M`` tokens and densifies
below.  The JAX package's measured table (a CPU campaign's, gated to that
backend) and its ``DISTRIFUSER_TPU_GEMM*`` environment override, which pins
Pallas tile sizes the CUDA kernel does not have, are not carried over
(ROADMAP queue 1 item 12).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GemmRoute:
    impl: str  # "dequant" | "dot" | "pallas"


GEMM_IMPLS = ("dequant", "dot", "pallas")

# the JAX package's crossover, carried over unmeasured on the card: below
# this many tokens (the time and conditioning embeddings, M = batch) the
# "auto" policy densifies, token streams take the 8-bit dot
DOT_MIN_M = 32


def resolve(mode: str, m: int, k: int, n: int, policy: str = "auto", *,
            platform: str) -> GemmRoute:
    """The GEMM path for one quantized matmul: ``mode`` the payload mode
    ("int8"/"fp8"), ``m`` the flattened token count, ``k``/``n`` the
    reduction and output widths, ``policy`` the leaf's compute policy,
    ``platform`` the activation's device type ("cpu" or "cuda")."""
    if policy == "dequant":
        return GemmRoute("dequant")
    if policy in ("dot", "pallas"):
        return GemmRoute(policy)
    if policy != "auto":
        raise ValueError(f"unknown quantized-compute policy {policy!r} (expected "
                         "'dequant', 'auto', 'dot', or 'pallas')")
    if platform == "cpu":
        return GemmRoute("dequant")
    return GemmRoute("dot" if m >= DOT_MIN_M else "dequant")
