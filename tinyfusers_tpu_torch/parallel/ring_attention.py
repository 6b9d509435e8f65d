"""Ring attention: sequence-parallel SDPA over a mesh axis (port of
tinyfusers_tpu/parallel/ring_attention.py).

Each rank of the axis's group holds its own rows of q, k and v and passes
its key / value chunk around the ring, one hop at a time to the next rank,
merging the partial attention of each chunk with the online-softmax rule.
The full (S, S) logits never exist: a rank holds its q, k and v chunks,
one chunk in flight and O(S_local^2) logits.

The math is the JAX package's, step for step: fp32 logits scaled after
the product; masked keys at -1e30, so that a chunk of padding alone gives
p = 1 over zero values and merges with weight 0; p cast to v's dtype
before P.V; fp32 running (m, l, acc); ``out = acc / max(l, 1e-30)`` in q's
dtype; n - 1 hops, each the rotation j -> j + 1. A sequence that does not
divide is split in chunks of c = ceil(S / n) rows (the JAX package's
zero-pad to a multiple of n): the last ranks' chunks are short or empty,
padded to c with zero rows whose keys a validity vector masks as it
travels with k and v.

Where the JAX package's shard_map takes arrays sharded on the sequence
axis, the port's activations are whole on every rank of the ring's group
(the model axis of ``generate(mesh=)``, over which a rank's rows are the
same). A model splits the sequence before its projections
(``split_sequence``): each rank projects only its rows to q, k and v,
runs the ring on them (``SequenceSplit.attend``) and gathers the output
rows back (``SequenceSplit.gather``), so that no rank computes or holds
the whole k / v. ``ring_attention`` is the JAX function's signature on
whole q, k and v: each rank takes its rows of them and runs the same
ring. The ring's axis must be one over which the activations are
replicated. ``batch_axis`` names the axis the batch rows are split over:
a rank's rows are already its own, so it only has to be an axis of the
mesh.

The hops are ``torch.distributed.batch_isend_irecv`` on the axis's group.
gloo does not take CUDA tensors in send / recv, so on a gloo group a CUDA
chunk travels through host memory (``transport``); the compute stays on
the tensors' device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import tp
from .mesh import MODEL_AXIS, Placement, axis as mesh_axis, current_mesh

NEG_INF = -1e30


def _local_block(q, k, v, scale: float, kvalid: Optional[torch.Tensor] = None):
    """Partial attention statistics of one (q chunk, k / v chunk) pair:
    q (..., Sq, D), k / v (..., Sk, D), kvalid optional (Sk,) bool ->
    (m (..., Sq, 1), l (..., Sq, 1), acc (..., Sq, D)), fp32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kvalid is not None:
        s = torch.where(kvalid, s, torch.full((), NEG_INF, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return m, l, acc


def _merge(m1, l1, a1, m2, l2, a2):
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    return m, c1 * l1 + c2 * l2, c1 * a1 + c2 * a2


def transport(group, like: torch.Tensor) -> str:
    """How a chunk travels between the ranks of ``group``: "host" for a CUDA
    tensor on a gloo group (gloo's send / recv take CPU tensors only),
    else "device"."""
    return "host" if like.is_cuda and dist.get_backend(group) == "gloo" else "device"


def _rotate(chunks: List[torch.Tensor], group, n: int, r: int) -> List[torch.Tensor]:
    """Every rank's ``chunks`` sent to the next rank of the ring; the
    previous rank's received."""
    ranks = dist.get_process_group_ranks(group)
    dst, src = ranks[(r + 1) % n], ranks[(r - 1) % n]
    host = transport(group, chunks[0]) == "host"
    send = [c.contiguous().cpu() if host else c.contiguous() for c in chunks]
    recv = [torch.empty_like(c) for c in send]
    ops = [dist.P2POp(dist.isend, c, dst, group, tag=i) for i, c in enumerate(send)]
    ops += [dist.P2POp(dist.irecv, c, src, group, tag=i) for i, c in enumerate(recv)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [c.to(old.device) if host else c for c, old in zip(recv, chunks)]


def _pad_rows(x: torch.Tensor, rows: int, dim: int) -> torch.Tensor:
    """x zero-padded along ``dim`` to ``rows``."""
    pad = rows - x.shape[dim]
    if not pad:
        return x
    return F.pad(x, (0, 0) * (x.ndim - 1 - dim % x.ndim) + (0, pad))


@dataclasses.dataclass(frozen=True)
class SequenceSplit:
    """A sequence of ``seq`` rows over the ``n`` ranks of ``group``, in
    chunks of ``c`` = ceil(seq / n): this rank (index ``r``) holds rows
    [lo, hi)."""

    seq: int
    n: int
    r: int
    group: object

    @property
    def c(self) -> int:
        return -(-self.seq // self.n)

    @property
    def lo(self) -> int:
        return min(self.r * self.c, self.seq)

    @property
    def hi(self) -> int:
        return min(self.lo + self.c, self.seq)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: Optional[float] = None) -> torch.Tensor:
        """This rank's output rows (..., hi - lo, D) of the attention over
        the whole sequence, from its own rows of q, k and v (..., hi - lo, D)."""
        rows, c, n = q.shape[-2], self.c, self.n
        if scale is None:
            scale = 1.0 / (q.shape[-1] ** 0.5)
        ql, kl, vl = (_pad_rows(x, c, -2) for x in (q, k, v))
        # the validity of this rank's keys, on every rank when the split pads
        kvl = None
        if self.seq % n:
            kvl = (torch.arange(c, device=q.device) < rows).to(torch.uint8)
        m, l, acc = _local_block(ql, kl, vl, scale, None if kvl is None else kvl.bool())
        for _ in range(n - 1):
            kl, vl, *rest = _rotate([kl, vl] + ([] if kvl is None else [kvl]), self.group,
                                    n, self.r)
            kvl = rest[0] if rest else None
            m2, l2, a2 = _local_block(ql, kl, vl, scale, None if kvl is None else kvl.bool())
            m, l, acc = _merge(m, l, acc, m2, l2, a2)
        out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
        return out[..., :rows, :]

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's rows of a tensor split as this sequence, along
        ``dim``, joined in order on every rank."""
        if self.n == 1:
            return x
        whole = tp.all_gather(_pad_rows(x, self.c, dim), self.group, dim=dim)
        return whole.narrow(dim, 0, self.seq)


def split_sequence(seq: int, *, mesh=None, axis: str = MODEL_AXIS,
                   batch_axis: Optional[str] = None) -> SequenceSplit:
    """The split of a ``seq``-row sequence over mesh axis ``axis``;
    mesh=None takes the ambient mesh (``parallel.use_mesh``), as a model
    reaches it."""
    if mesh is None:
        mesh = current_mesh()
        if mesh is None:
            raise ValueError("ring_attention: no mesh: pass mesh= or enter parallel.use_mesh")
    for name in (axis, batch_axis):
        if name is not None and name not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"ring_attention: the mesh has no axis {name!r} "
                             f"(axes {mesh.mesh_dim_names})")
    n, r, group = mesh_axis(mesh, axis)
    return SequenceSplit(seq, n, r, group)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh=None,
                   axis: str = MODEL_AXIS, batch_axis: Optional[str] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Full (non-causal) attention over (..., S, D) with the sequence split
    over mesh axis ``axis``: q, k and v whole on every rank of the axis's
    group, the output whole too. mesh=None takes the ambient mesh
    (``parallel.use_mesh``), as ``ops.sdpa(impl="ring:...")`` reaches it."""
    sp = split_sequence(q.shape[-2], mesh=mesh, axis=axis, batch_axis=batch_axis)
    rows = lambda x: x[..., sp.lo:sp.hi, :]  # noqa: E731
    return sp.gather(sp.attend(rows(q), rows(k), rows(v), scale), dim=-2)


def ring_axes(impl: str) -> Tuple[str, Optional[str]]:
    """(sequence axis, batch axis or None) of an impl string
    "ring[:seq_axis[,batch_axis]]"; the sequence axis defaults to model."""
    spec = impl.split(":", 1)[1] if ":" in impl else MODEL_AXIS
    parts = [p for p in spec.split(",") if p]
    return (parts[0] if parts else MODEL_AXIS), (parts[1] if len(parts) > 1 else None)


def is_ring(impl: Optional[str]) -> bool:
    return bool(impl) and impl.startswith("ring")


def split_for(seq: int, impl: str) -> SequenceSplit:
    """The sequence split of an impl "ring[:seq_axis[,batch_axis]]" on the
    ambient mesh: a model's self-attention projects rows [lo, hi) only."""
    seq_axis, batch_axis = ring_axes(impl)
    return split_sequence(seq, axis=seq_axis, batch_axis=batch_axis)


def ring_sdpa(q, k, v, impl: str, scale: Optional[float] = None) -> torch.Tensor:
    """ops.sdpa's ring entry: impl = "ring[:seq_axis[,batch_axis]]" (e.g.
    "ring:model" or "ring:model,data"), on the ambient mesh."""
    seq_axis, batch_axis = ring_axes(impl)
    return ring_attention(q, k, v, axis=seq_axis, batch_axis=batch_axis, scale=scale)


def sequence_sharded(mesh, axis: str, ndim: int) -> Placement:
    """The placement of a (..., S, D) tensor whose sequence axis is split
    over ``axis``: the JAX ``NamedSharding`` with spec (..., axis, None)."""
    spec = (None,) * (ndim - 2) + (axis, None)
    dim = {"model_dim": ndim - 2} if axis == MODEL_AXIS else {"data_dim": ndim - 2}
    return Placement(mesh, spec, **dim)
