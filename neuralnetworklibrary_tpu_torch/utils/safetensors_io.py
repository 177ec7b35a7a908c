"""Dependency-free safetensors reader and writer (numpy dicts).

A copy of ``neuralnetworklibrary_tpu/utils/safetensors_io.py``, kept here
because the port imports nothing of the JAX package (and the card's
machine has no ``safetensors`` package).  The converters
(``utils.llama_convert``) take plain state-dict mappings; this module
reads a ``.safetensors`` file into ``{name: np.ndarray}``.

Format: 8-byte little-endian header length N, then N bytes of JSON mapping
tensor name to ``{"dtype", "shape", "data_offsets": [begin, end)}``
(offsets into the byte buffer that follows; an optional ``__metadata__``
entry), then the raw little-endian tensor buffer.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
    # BF16 has no numpy dtype: widened to float32 on load (exact)
}
_TO_TAG = {np.dtype(v): k for k, v in _DTYPES.items()}


def load_safetensors(path: str) -> dict:
    """Read a .safetensors file into {name: np.ndarray}; bf16 tensors are
    widened to float32 (exact)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n).decode("utf-8"))
        buf = np.fromfile(f, np.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        b, e = info["data_offsets"]
        raw = buf[b:e]
        shape = tuple(info["shape"])
        tag = info["dtype"]
        if tag == "BF16":
            # bf16 bits are the high half of the float32 pattern
            u16 = raw.view(np.uint16).astype(np.uint32) << 16
            out[name] = u16.view(np.float32).reshape(shape)
        elif tag in _DTYPES:
            out[name] = raw.view(_DTYPES[tag]).reshape(shape)
        else:
            raise ValueError(f"unsupported safetensors dtype {tag!r} "
                             f"for {name!r}")
    return out


def load_safetensors_auto(path: str) -> dict:
    """One flat {name: np.ndarray} from a single ``.safetensors`` file, a
    ``*.safetensors.index.json`` (shards resolved beside it), or a
    directory holding either (the index wins; with neither, every
    ``*.safetensors`` file in it is merged)."""
    if os.path.isdir(path):
        idx = [f for f in sorted(os.listdir(path))
               if f.endswith(".safetensors.index.json")]
        if idx:
            return load_safetensors_auto(os.path.join(path, idx[0]))
        shards = [f for f in sorted(os.listdir(path))
                  if f.endswith(".safetensors")]
        if not shards:
            raise FileNotFoundError(f"no .safetensors files under {path!r}")
        out = {}
        for f in shards:
            out.update(load_safetensors(os.path.join(path, f)))
        return out
    if path.endswith(".index.json"):
        with open(path) as f:
            index = json.load(f)
        base = os.path.dirname(path)
        out = {}
        for shard in sorted(set(index["weight_map"].values())):
            out.update(load_safetensors(os.path.join(base, shard)))
        missing = set(index["weight_map"]) - set(out)
        if missing:
            raise ValueError(f"index names {len(missing)} tensors absent "
                             f"from shards, e.g. {sorted(missing)[:3]}")
        return out
    return load_safetensors(path)


def save_safetensors(tensors: dict, path: str, metadata: dict | None = None):
    """Write {name: array} as a .safetensors file."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v)
                                  for k, v in metadata.items()}
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype not in _TO_TAG:
            raise ValueError(f"unsupported dtype {arr.dtype} for {name!r}")
        raw = arr.tobytes()
        header[str(name)] = {"dtype": _TO_TAG[arr.dtype],
                             "shape": list(arr.shape),
                             "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        blobs.append(raw)
    hj = json.dumps(header, separators=(",", ":")).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hj)))
        f.write(hj)
        for raw in blobs:
            f.write(raw)
