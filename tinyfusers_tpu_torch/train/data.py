"""Host-side data feeding for training (port of the single-device part of
tinyfusers_tpu/train/data.py).

Fine-tunes train on precomputed latents and text embeddings, so the
feed is array-based: ``LatentDataset`` shuffles in-memory arrays with
numpy's ``default_rng(seed).permutation``, so its batches are the JAX
package's for the same seed; ``write_shard`` writes the TFLS shard format
that ``NativeShardDataset`` serves through the C++ prefetching loader
(``native/loader.cpp``, built by ``native/__init__.py``). On a mesh
(parallel/), ``shard_batch`` gives each rank its rows of a global host
batch and ``make_global_batch`` takes each rank's own rows as they are.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Iterator, Sequence, Tuple, Union

import numpy as np
import torch

from ..parallel import tp
from ..parallel.mesh import DATA_AXIS, axis, mesh_device

Array = Union[np.ndarray, torch.Tensor]


class LatentDataset:
    """In-memory (latents, *conditioning) arrays with shuffled epochs.

    arrays: equal-length numpy arrays, batch leading. Yields tuples of
    per-batch numpy slices; the trailing partial batch is dropped.
    """

    def __init__(self, *arrays: np.ndarray, batch_size: int, seed: int = 0,
                 shuffle: bool = True):
        n = arrays[0].shape[0]
        for a in arrays:
            if a.shape[0] != n:
                raise ValueError("all arrays must share the batch dim")
        if batch_size > n:
            raise ValueError(f"batch_size {batch_size} > dataset size {n}")
        self.arrays = arrays
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.arrays[0].shape[0] // self.batch_size

    def epoch(self) -> Iterator[Tuple[np.ndarray, ...]]:
        n = self.arrays[0].shape[0]
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        for i in range(len(self)):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            yield tuple(a[idx] for a in self.arrays)


def shard_batch(batch: Sequence[Array], mesh=None) -> Tuple[torch.Tensor, ...]:
    """Each array of a global host batch as a tensor: without a mesh the
    whole of it (on the CPU), on a mesh this rank's rows (part r of the
    data axis's n equal parts, r its data index) on the mesh's device,
    the same on every rank of a model group."""
    out = tuple(torch.as_tensor(np.asarray(b) if not isinstance(b, torch.Tensor) else b)
                for b in batch)
    if mesh is None:
        return out
    n, r, _ = axis(mesh, DATA_AXIS)
    for b in out:
        if b.shape[0] % n:
            raise ValueError(f"batch {b.shape[0]} does not split over {n} data ranks")
    dev = mesh_device(mesh)
    return tuple(tp.rank_slice(b, 0, r, n).to(dev) for b in out)


def make_global_batch(local_batch: Sequence[Array], mesh) -> Tuple[torch.Tensor, ...]:
    """Each rank's own rows of a global batch (the rows of data rank r,
    the global batch their concatenation in data order; the ranks of a
    model group hold the same rows) on the mesh's device, as they are.
    Raises unless every rank holds as many rows."""
    out = tuple(torch.as_tensor(np.asarray(b) if not isinstance(b, torch.Tensor) else b)
                for b in local_batch)
    dev = mesh_device(mesh)
    rows = torch.tensor([b.shape[0] for b in out], dtype=torch.int64, device=dev)
    every = tp.all_gather(rows[None], torch.distributed.group.WORLD, dim=0)
    if bool((every != every[0]).any()):
        raise ValueError(f"ranks hold unequal local batches: {every.tolist()}")
    return tuple(b.to(dev) for b in out)


# TFLS dtype codes (native/loader.cpp)
_DTYPE_CODES = {"float32": 0, "float16": 1, "bfloat16": 2, "int32": 3}
_CODE_TORCH = {0: torch.float32, 1: torch.float16, 2: torch.bfloat16, 3: torch.int32}


def _dtype_name(a: Array) -> str:
    return str(a.dtype).replace("torch.", "")


def _bytes(a: Array) -> bytes:
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        return t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def write_shard(path, *arrays: Array) -> None:
    """Write equal-length arrays (numpy arrays or torch tensors) to the TFLS
    shard format of native/loader.cpp: a little-endian header, then each
    array contiguous at 64-byte alignment."""
    n = arrays[0].shape[0]
    for a in arrays:
        if a.shape[0] != n:
            raise ValueError("all arrays must share the batch dim")
        if _dtype_name(a) not in _DTYPE_CODES:
            raise ValueError(f"unsupported dtype {a.dtype}")
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x534C4654, 1, len(arrays)))
        for a in arrays:
            f.write(struct.pack("<II", _DTYPE_CODES[_dtype_name(a)], a.ndim))
            f.write(struct.pack(f"<{a.ndim}Q", *a.shape))
        for a in arrays:
            f.write(b"\0" * ((-f.tell()) % 64))
            f.write(_bytes(a))


class NativeShardDataset:
    """Shuffled batches over a TFLS shard via the C++ prefetching loader.

    The same epoch() / len() surface as LatentDataset; batches are CPU
    tensors in the shard's dtypes (bf16 included). The loader is a
    continuous shuffled stream (reshuffled per full pass) that epoch()
    chunks into len(self)-batch runs, so an abandoned epoch() resumes the
    stream. Raises when libtfnative cannot be built (no C++ compiler): use
    LatentDataset then.
    """

    def __init__(self, path, *, batch_size: int, seed: int = 0, shuffle: bool = True,
                 prefetch: int = 2):
        from ..native import get_lib

        lib = get_lib()
        if lib is None:
            raise RuntimeError("libtfnative unavailable (no C++ compiler); use "
                               "LatentDataset instead")
        self._lib = lib
        self._h = lib.tf_loader_open(str(path).encode(), batch_size, seed, int(shuffle),
                                     prefetch)
        if not self._h:
            raise ValueError(f"could not open shard {path}")
        self.batch_size = batch_size
        self._n_records = lib.tf_loader_num_records(self._h)
        self._shapes, self._dtypes = [], []
        for ai in range(lib.tf_loader_num_arrays(self._h)):
            nd = lib.tf_loader_ndim(self._h, ai)
            dims = (ctypes.c_ulong * nd)()
            lib.tf_loader_dims(self._h, ai, dims)
            self._shapes.append((batch_size, *list(dims)[1:]))
            self._dtypes.append(_CODE_TORCH[lib.tf_loader_dtype(self._h, ai)])

    def __len__(self) -> int:
        return self._n_records // self.batch_size

    def epoch(self) -> Iterator[Tuple[torch.Tensor, ...]]:
        for _ in range(len(self)):
            if not self._lib.tf_loader_next(self._h):  # pragma: no cover
                return
            out = []
            for ai, (shape, dt) in enumerate(zip(self._shapes, self._dtypes)):
                buf = torch.empty(shape, dtype=dt)
                self._lib.tf_loader_copy(self._h, ai, ctypes.c_void_p(buf.data_ptr()))
                out.append(buf)
            yield tuple(out)

    def close(self) -> None:
        if self._h:
            self._lib.tf_loader_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
