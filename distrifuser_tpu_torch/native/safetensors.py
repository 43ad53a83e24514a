"""Safetensors checkpoint shards read in pure Python.

Counterpart of distrifuser_tpu/models/weights.py ``load_safetensors`` and
``load_sharded_safetensors`` (whose native reader is
distrifuser_tpu/native/fast_safetensors.cc), with neither a compiled
reader nor the ``safetensors`` package.  A file is an 8-byte little-endian
header length, a JSON header mapping each tensor name to its dtype, shape
and byte range in the data that follows, and the data.  The file is mapped
copy-on-write (``mmap`` with ``ACCESS_COPY``, so that ``torch.frombuffer``
gets a writable buffer and nothing is written back) and each tensor is a
view of the mapping; the mapping lives as long as a view does.  F32, F16
and BF16 are read; any other dtype raises, unless the tensor's name holds
one of the ``skip`` substrings, whose tensors are not read at all (older
transformers text encoders carry an I64 ``position_ids`` buffer, which the
converters drop).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Optional

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def load_safetensors(path: str, skip=()) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file whose name holds none of
    the ``skip`` substrings, as CPU views of its mapping."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        size = os.fstat(f.fileno()).st_size
        mapping = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else None
    base = 8 + header_len
    out = {}
    for name, entry in header.items():
        if name == "__metadata__" or any(s in name for s in skip):
            continue
        dtype = DTYPES.get(entry["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {entry['dtype']}; "
                             f"the reader takes {sorted(DTYPES)}")
        start, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        numel = 1
        for n in shape:
            numel *= n
        if (end - start) != numel * dtype.itemsize or base + end > size:
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} and dtype "
                             f"{entry['dtype']} has byte range {start}..{end}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(mapping, dtype=dtype, count=numel,
                                         offset=base + start).reshape(shape)
    return out


def load_sharded_safetensors(model_dir: str, variant: Optional[str] = None,
                             skip=()) -> Dict[str, torch.Tensor]:
    """The ``*.safetensors`` shards of a directory as one state dict.

    A snapshot may hold base and variant weights side by side
    (``diffusion_pytorch_model.safetensors`` and
    ``diffusion_pytorch_model.fp16.safetensors``) under the same tensor
    names.  With ``variant`` (e.g. "fp16") only its files load; without it
    variant files are skipped whenever base files exist.  ``skip`` as in
    ``load_safetensors``."""
    names = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if variant:
        names = [f for f in names if f".{variant}." in f]
        if not names:
            raise FileNotFoundError(f"no .{variant}. safetensors shards in {model_dir}")
    else:
        # "name.safetensors" and "name-00001-of-00002.safetensors" are base,
        # "name.fp16.safetensors" a variant (three dot-separated parts)
        base = [f for f in names if len(f.split(".")) == 2]
        if base:
            names = base
    sd: Dict[str, torch.Tensor] = {}
    for fname in names:
        sd.update(load_safetensors(os.path.join(model_dir, fname), skip))
    return sd
