"""A reader of ``.safetensors`` files that needs no ``safetensors`` package.

The format: an 8-byte little-endian header length N, N bytes of JSON
mapping each tensor's name to ``{"dtype", "shape", "data_offsets": [begin,
end]}`` (offsets into the buffer that follows the header; the key
``__metadata__`` holds free-form strings and is ignored), then the raw
little-endian buffer. Released HVI-CIDNet weights and the JAX package's
``save_pretrained`` folders (``model.safetensors``) come in it.
"""

from __future__ import annotations

import json
import math
from typing import Dict

import torch

# the dtypes a checkpoint of this model holds
DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "F64": torch.float64}
_HEADER_LEN_BYTES = 8


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file, on the CPU, in their stored
    dtype. Raises ``ValueError`` on a header that does not parse, a dtype
    outside ``DTYPES``, or offsets that leave the buffer or disagree with the
    shape."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < _HEADER_LEN_BYTES:
        raise ValueError(f"{path}: {len(raw)} bytes, too short for a safetensors header")
    n = int.from_bytes(raw[:_HEADER_LEN_BYTES], "little")
    if n > len(raw) - _HEADER_LEN_BYTES:
        raise ValueError(f"{path}: header of {n} bytes runs past the end of the file "
                         f"({len(raw)} bytes)")
    try:
        header = json.loads(raw[_HEADER_LEN_BYTES:_HEADER_LEN_BYTES + n])
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: header is not JSON: {e}") from None
    buffer = memoryview(raw)[_HEADER_LEN_BYTES + n:]
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info.get("dtype"))
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info.get('dtype')!r}; "
                             f"supported: {', '.join(DTYPES)}")
        shape = [int(d) for d in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        size = math.prod(shape) * dtype.itemsize
        if not 0 <= begin <= end <= len(buffer) or end - begin != size:
            raise ValueError(f"{path}: tensor {name!r} {info['dtype']}{shape} at offsets "
                             f"[{begin}, {end}) does not fit a buffer of {len(buffer)} bytes "
                             f"({size} bytes expected)")
        data = bytearray(buffer[begin:end])  # a copy: the tensor owns its memory
        t = torch.frombuffer(data, dtype=dtype) if size else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(shape)
    return out
