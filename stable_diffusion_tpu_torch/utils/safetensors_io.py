"""A reader and writer of the safetensors format on numpy and torch alone
(the JAX package reads with the ``safetensors`` package; the port does not
depend on it).

The format: a little-endian u64 header length; a JSON header of ``{name:
{"dtype", "shape", "data_offsets": [begin, end]}}`` with an optional
``"__metadata__"`` of strings; then the raw little-endian bytes, the offsets
counted from the end of the header.  The reader maps the file once
(``np.memmap``, copy-on-write) and hands out torch views of it, so a 3.4 GB
UNet is not copied on the host before it is loaded into a module; BF16 is
read as uint16 and viewed as ``torch.bfloat16``, never through float16.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of the bytes, torch dtype handed on)
_DTYPES = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "BOOL": (np.bool_, torch.bool),
}
_NAMES = {t: name for name, (_, t) in _DTYPES.items()}


def read_header(path: str) -> Tuple[Dict, int]:
    """(header without ``__metadata__``, offset of the data) of a file,
    checked against its size: every tensor's offsets lie inside the data
    and span its shape's bytes."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes runs past the file's {size}")
        header = json.loads(f.read(n).decode("utf-8"))
    header.pop("__metadata__", None)
    start, data = 8 + n, size - 8 - n
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unknown dtype {info['dtype']!r}")
        begin, end = info["data_offsets"]
        want = int(np.prod(info["shape"], dtype=np.int64)) * np.dtype(_DTYPES[info["dtype"]][0]).itemsize
        if not 0 <= begin <= end <= data or end - begin != want:
            raise ValueError(f"{path}: tensor {name!r} has offsets {begin}..{end} for {want} bytes "
                             f"of {info['dtype']} {info['shape']} in {data} bytes of data")
    return header, start


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a safetensors file, in the file's dtypes, on the
    CPU, as views of one copy-on-write map of the file."""
    header, start = read_header(path)
    if not header:
        return {}
    mm = (np.memmap(path, dtype=np.uint8, mode="c", offset=start)
          if os.path.getsize(path) > start else np.zeros(0, np.uint8))  # only empty tensors
    out = {}
    for name, info in header.items():
        np_dtype, torch_dtype = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        raw = mm[begin:end]
        if begin % np.dtype(np_dtype).itemsize:  # a misaligned tensor gets its own copy
            raw = raw.copy()
        arr = raw.view(np_dtype).reshape(info["shape"])
        t = torch.from_numpy(arr)
        out[name] = t.view(torch_dtype) if torch_dtype != t.dtype else t
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (torch tensors or numpy arrays) as a safetensors
    file: wider dtypes first, then by name, so every tensor's offset is a
    multiple of its item size; the header padded with spaces to 8 bytes."""
    ts = {k: (torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v)
          .detach().cpu().contiguous() for k, v in tensors.items()}
    for k, t in ts.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {k!r}: dtype {t.dtype} has no safetensors name")
    order = sorted(ts, key=lambda k: (-ts[k].element_size(), k))
    header, offset = {}, 0
    for k in order:
        n = ts[k].numel() * ts[k].element_size()
        header[k] = {"dtype": _NAMES[ts[k].dtype], "shape": list(ts[k].shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for k in order:
            t = ts[k]
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
