"""A safetensors reader and writer on numpy and torch alone.

The format: an 8-byte little-endian header length, a JSON header mapping
each tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets relative to the end of the header; an optional ``__metadata__``
entry), then the raw little-endian bytes. The port keeps its own codec
because the card's machine has no ``safetensors`` package.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import numpy as np
import torch

_TO_NP = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
          "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
          "U8": np.uint8, "BOOL": np.bool_}
_FROM_TORCH = {torch.float64: "F64", torch.float32: "F32",
               torch.float16: "F16", torch.bfloat16: "BF16",
               torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
               torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Read every tensor of one .safetensors file into CPU tensors."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8: 8 + n])
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        raw = np.frombuffer(data, dtype=np.uint8, count=hi - lo,
                            offset=base + lo)
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            arr = raw.view(np.uint16).reshape(shape).copy()
            out[name] = torch.from_numpy(arr).view(torch.bfloat16)
        else:
            arr = raw.view(_TO_NP[info["dtype"]]).reshape(shape).copy()
            out[name] = torch.from_numpy(arr)
    return out


def save_file(tensors: Dict[str, object], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write tensors (torch or numpy) as one .safetensors file."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = metadata
    blobs = []
    offset = 0
    for name, t in tensors.items():
        t = t if isinstance(t, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(t))
        t = t.detach().cpu().contiguous()
        dtype = _FROM_TORCH[t.dtype]
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy().tobytes()
        else:
            raw = t.numpy().tobytes()
        header[name] = {"dtype": dtype, "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # align the data section to 8 bytes
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
