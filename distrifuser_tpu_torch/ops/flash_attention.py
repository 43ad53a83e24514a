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
The kernel has an instance for each head dim in ``HEAD_DIMS``, and a second
one with a log-sum-exp output: ``return_lse=True`` returns ``(out, lse)``,
the output in float32 and ``lse [B, H, Lq]`` the natural-log log-sum-exp of
each query row's scaled logits, float32, which ring attention
(ops/ring_attention.py) merges chunk partials by.
On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
``flash_sdpa_reference``.  Unlike the Pallas kernel, the lengths need not
be block multiples: the kernel masks ragged query and KV edges itself.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ._build import KernelLibrary, add_launches, counts_launches

_NEG_INF = -1e30  # masked-logit convention of the TPU kernel
# head dims the kernel has an instance for: every d a configuration of the
# repo gives (SDXL and SD 2.x UNet 64, SD 1.x UNet 40, 80 and 160, PixArt-α's
# DiT 72, the VAE 512, tiny configs 16 and 32) and 128, 256
HEAD_DIMS = (16, 32, 40, 64, 72, 80, 128, 160, 256, 512)


def _bind(lib) -> None:
    for name, pointers in (("flash_sdpa_bf16", 4), ("flash_sdpa_bf16_lse", 5)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * pointers + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 8 + [ctypes.c_float, ctypes.c_void_p]
        )
    info = lib.flash_sdpa_variant
    info.restype = ctypes.c_int
    info.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 5


_KERNEL = KernelLibrary("flash_attention.cu", _bind)


def build() -> str:
    """Compile and load ``csrc/flash_attention.cu`` (ops/_build.py); returns
    the compiler's ptxas report, or "" when an earlier build was reused."""
    return _KERNEL.build()


def variant(d: int, lse: bool = False) -> dict:
    """What the kernel instance for head dim ``d`` (its log-sum-exp one with
    ``lse``) uses on the card: registers per thread (as compiled), dynamic
    shared memory bytes and threads per block, KV rows per tile, query rows
    per block."""
    keys = ("registers", "smem_bytes", "threads", "block_k", "block_q")
    vals = [ctypes.c_int(0) for _ in keys]
    rc = _KERNEL.lib.flash_sdpa_variant(d, int(lse), *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise ValueError(f"flash_sdpa has no kernel instance for d={d} (cudaError {rc})")
    return {k: v.value for k, v in zip(keys, vals)}


def flash_sdpa_reference(q, k, v, *, heads: int, kv_len: int = None,
                         return_lse: bool = False):
    """Plain PyTorch flash_sdpa: float32 logits, the -1e30 KV mask, p
    rounded to V's dtype before the PV product (float32 accumulation), the
    normalizer applied after it, output in q's dtype; with ``return_lse``
    ``(out float32, lse [B, H, Lq] float32)``, lse = max + log(sum)."""
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
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), vh.float())
    out = acc / l
    if return_lse:
        lse = (m + torch.log(l)).squeeze(-1)
        return out.transpose(1, 2).reshape(b, lq, c), lse
    return out.to(q.dtype).transpose(1, 2).reshape(b, lq, c)


@counts_launches
def flash_sdpa(q, k, v, *, heads: int, kv_len: int = None, return_lse: bool = False):
    """SDPA over [B, L, C] with ``heads`` heads: the kernel on the card,
    the plain version on the CPU; ``return_lse`` gives ``(out float32,
    lse [B, H, Lq] float32)``.  Counts each kernel launch in
    ``flash_sdpa.launches`` and, by head dim (the instance launched), in
    ``flash_sdpa.launches_by_head_dim``, a log-sum-exp instance's also in
    ``flash_sdpa.lse_launches`` and ``flash_sdpa.lse_launches_by_head_dim``;
    graph replays add to ``launches`` and ``lse_launches``, not by head dim
    (parallel/graphs.py)."""
    if q.device.type == "cpu":
        return flash_sdpa_reference(q, k, v, heads=heads, kv_len=kv_len,
                                    return_lse=return_lse)
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if return_lse:
        out = torch.empty((b, lq, c), dtype=torch.float32, device=q.device)
        lse = torch.empty((b, heads, lq), dtype=torch.float32, device=q.device)
        entry, ptrs = _KERNEL.lib.flash_sdpa_bf16_lse, (out.data_ptr(), lse.data_ptr())
    else:
        out = torch.empty((b, lq, c), dtype=q.dtype, device=q.device)
        entry, ptrs = _KERNEL.lib.flash_sdpa_bf16, (out.data_ptr(),)
    rc = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs,
        b, heads, lq, kv, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        1.0 / d**0.5, stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_sdpa kernel launch failed: cudaError {rc}")
    add_launches(flash_sdpa, head_dim=d)
    if return_lse:
        add_launches(flash_sdpa, attr="lse_launches", head_dim=d)
    return (out, lse) if return_lse else out


flash_sdpa.launches_by_head_dim = collections.Counter()
flash_sdpa.lse_launches = 0
flash_sdpa.lse_launches_by_head_dim = collections.Counter()
