"""safetensors reader and writer with no safetensors-library dependency
(port of tinyfusers_tpu/io/safetensors_io.py).

Format: an 8-byte little-endian header length, a JSON header mapping each
tensor name to {dtype, shape, data_offsets: [start, end]} (offsets from
the end of the header), then the raw little-endian payload. The file is
memory-mapped copy-on-write, so a tensor is read from the page cache when
it is first used, and each tensor is a view of the map (a copy where its
offset is not a multiple of its element size, which torch needs).

torch has every dtype of the format, bf16 and fp8 included, so tensors are
made from the bytes directly: no numpy dtype is needed for them.
"""
from __future__ import annotations

import json
import mmap
from pathlib import Path
from typing import Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
_NAMES = {v: k for k, v in _DTYPES.items()}

# numpy arrays whose dtype numpy itself lacks (ml_dtypes' bfloat16 and
# float8) -> the unsigned view of their bytes and the torch dtype
_NUMPY_EXTRA = {"bfloat16": (np.uint16, torch.bfloat16),
                "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
                "float8_e5m2": (np.uint8, torch.float8_e5m2)}


class SafetensorsFile:
    def __init__(self, path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            header_len = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(header_len))
            self._data_start = 8 + header_len
            # copy-on-write: writable for torch.frombuffer, never written back
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self.metadata = header.pop("__metadata__", {})
        self._index = header

    def get(self, name: str) -> torch.Tensor:
        """A CPU tensor over the map (the map stays open while it lives)."""
        info = self._index[name]
        dtype = _DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end == start:
            return torch.empty(shape, dtype=dtype)
        raw = torch.frombuffer(self._mm, dtype=torch.uint8, count=end - start,
                               offset=self._data_start + start)
        if (self._data_start + start) % dtype.itemsize:
            raw = raw.clone()  # an aligned copy
        return raw.view(dtype).reshape(shape)

    def items(self) -> Iterator[Tuple[str, torch.Tensor]]:
        for k in self._index:
            yield k, self.get(k)


def load_state_dict(path) -> Dict[str, torch.Tensor]:
    return dict(SafetensorsFile(path).items())


def _as_tensor(value: Union[torch.Tensor, np.ndarray]) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu").contiguous()
    arr = np.asarray(value)
    arr = np.ascontiguousarray(arr).reshape(arr.shape)  # which keeps a 0-d array 0-d
    if arr.dtype.name in _NUMPY_EXTRA:
        view, dtype = _NUMPY_EXTRA[arr.dtype.name]
        return torch.from_numpy(arr.view(view)).view(dtype)
    return torch.from_numpy(arr)


def save_state_dict(state: Mapping[str, Union[torch.Tensor, np.ndarray]], path) -> None:
    """Write ``state`` (torch tensors on any device, or numpy arrays). The
    header is padded with spaces to a multiple of 8 bytes, so that the
    payload starts aligned."""
    header = {}
    tensors = []
    offset = 0
    for name, value in state.items():
        t = _as_tensor(value)
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        tensors.append(t)
        offset += nbytes
    hjson = json.dumps(header).encode()
    hjson += b" " * (-len(hjson) % 8)
    with open(path, "wb") as f:
        f.write(len(hjson).to_bytes(8, "little"))
        f.write(hjson)
        for t in tensors:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
