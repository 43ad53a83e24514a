"""Flash attention: the hand-written Hopper kernel, its wrapper and its plain
version.

Counterpart of distrifuser_tpu/ops/flash_attention.py (``_flash_kernel``
launched by ``flash_sdpa``).  The kernel is CUDA C++ for sm_90a in
``csrc/flash_attention.cu`` (TMA tile ring, wgmma for both products,
softmax and accumulator in registers); its header comment gives the
design and what bounds it.  It is built with ``nvcc`` at first use, from
this package's sources, into ``build/kernels/`` beside the package, and
bound through a plain C entry point loaded with ``ctypes``
(ops/_build.py).

``flash_sdpa`` takes the JAX signature: q ``[B, Lq, C]``, k and v
``[B, Lk, C]``, ``heads`` heads of ``d = C / heads`` columns, an optional
``kv_len`` that treats only the first ``kv_len`` KV positions as real.
The kernel has an instance for each head dim in ``HEAD_DIMS``.
On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
``flash_sdpa_reference``.  Unlike the Pallas kernel, the lengths need not
be block multiples: the kernel masks ragged query and KV edges itself.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import KernelLibrary

_NEG_INF = -1e30  # masked-logit convention of the TPU kernel
# head dims the kernel has an instance for: every d a configuration of the
# repo gives (SDXL UNet 64, SDXL VAE 512, tiny configs 16 and 32) and 128, 256
HEAD_DIMS = (16, 32, 64, 128, 256, 512)


def _bind(lib) -> None:
    fn = lib.flash_sdpa_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 8 + [ctypes.c_float, ctypes.c_void_p]
    )
    info = lib.flash_sdpa_variant
    info.restype = ctypes.c_int
    info.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 5


_KERNEL = KernelLibrary("flash_attention.cu", _bind)


def build() -> str:
    """Compile and load ``csrc/flash_attention.cu`` (ops/_build.py); returns
    the compiler's ptxas report, or "" when an earlier build was reused."""
    return _KERNEL.build()


def variant(d: int) -> dict:
    """What the kernel instance for head dim ``d`` uses on the card:
    registers per thread (as compiled), dynamic shared memory bytes and
    threads per block, KV rows per tile, query rows per block."""
    keys = ("registers", "smem_bytes", "threads", "block_k", "block_q")
    vals = [ctypes.c_int(0) for _ in keys]
    rc = _KERNEL.lib.flash_sdpa_variant(d, *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise ValueError(f"flash_sdpa has no kernel instance for d={d} (cudaError {rc})")
    return {k: v.value for k, v in zip(keys, vals)}


def flash_sdpa_reference(q, k, v, *, heads: int, kv_len: int = None):
    """Plain PyTorch flash_sdpa: float32 logits, the -1e30 KV mask, p
    rounded to V's dtype before the PV product (float32 accumulation), the
    normalizer applied after it, output in q's dtype."""
    b, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    qh = q.reshape(b, lq, heads, d).transpose(1, 2).float()
    kh = k.reshape(b, lk, heads, d).transpose(1, 2).float()
    vh = v.reshape(b, lk, heads, d).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / d**0.5)
    if kv_len is not None and kv_len < lk:
        col = torch.arange(lk, device=q.device)
        s = s.masked_fill(col >= kv_len, _NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), vh.float())
    out = (acc / l).to(q.dtype)
    return out.transpose(1, 2).reshape(b, lq, c)


def flash_sdpa(q, k, v, *, heads: int, kv_len: int = None):
    """SDPA over [B, L, C] with ``heads`` heads: the kernel on the card,
    the plain version on the CPU.  Counts each kernel launch in
    ``flash_sdpa.launches``."""
    if q.device.type == "cpu":
        return flash_sdpa_reference(q, k, v, heads=heads, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_sdpa: unsupported device {q.device}")
    b, lq, c = q.shape
    lk = k.shape[1]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_sdpa: {name} on {t.device}, q on {q.device}")
        if t.dim() != 3 or t.shape[0] != b or t.shape[2] != c or t.shape[1] != lk:
            raise ValueError(f"flash_sdpa: {name} shape {tuple(t.shape)} does not "
                             f"match q {tuple(q.shape)} / k {tuple(k.shape)}")
    if c % heads:
        raise ValueError(f"flash_sdpa: {c} channels not divisible by {heads} heads")
    d = c // heads
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_sdpa kernel takes head dims {HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_sdpa kernel takes bfloat16, {name} is {t.dtype}")
        if t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8:
            raise ValueError(f"flash_sdpa: {name} needs unit channel stride and "
                             f"16-byte aligned rows, strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_sdpa: {name} data is not 16-byte aligned")
    kv = lk if kv_len is None else min(kv_len, lk)
    if lq == 0 or kv <= 0:
        raise ValueError(f"flash_sdpa: empty attention (Lq={lq}, kv_len={kv})")
    out = torch.empty((b, lq, c), dtype=q.dtype, device=q.device)
    rc = _KERNEL.lib.flash_sdpa_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, heads, lq, kv, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        1.0 / d**0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_sdpa kernel launch failed: cudaError {rc}")
    flash_sdpa.launches += 1
    return out


flash_sdpa.launches = 0
