"""The collectives of the sharded steps, on one axis of a ``DeviceMesh``.

JAX's ``shard_map`` collectives become ``torch.distributed`` calls on the
axis's process group, one rank a process:

- ``ring_forward`` is ``ppermute`` with the permutation [(j, (j+1) % d)]:
  one ``batch_isend_irecv`` of a send to the next rank and a receive from
  the previous one, peers mapped to global ranks with ``get_global_rank``;
- ``psum`` and ``pmean`` are ``all_reduce`` (sum, then a divide by d);
- ``broadcast`` from one rank of the axis stands where JAX masks every
  rank but one and takes a ``psum``: it is exact for every dtype;
- ``all_to_all`` is ``all_to_all(..., tiled=True)``: one
  ``all_to_all_single`` of the tensor split into d blocks along one
  dimension, the blocks received laid out along another in axis order.

``mesh=None`` is one rank with no process group: every collective is the
identity, as on a JAX mesh over one device.  At axis size 1 the ring hop
and the all-to-all return their input (gloo refuses a send to the own
rank); the reductions
still run on the group, summing one rank, which is exact.  A collective
that fails raises (gloo at once; NCCL when the call or its wait reports
the error).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def axis_size(mesh: DeviceMesh | None, axis: str = "shard") -> int:
    """Ranks along ``axis`` (JAX's ``mesh.shape[axis]``)."""
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh | None, axis: str = "shard") -> int:
    """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def _peer(group, index: int) -> int:
    return dist.get_global_rank(group, index)


def ring_forward(t: torch.Tensor, mesh: DeviceMesh | None,
                 axis: str = "shard") -> torch.Tensor:
    """The previous rank's ``t`` along ``axis`` (rank 0 gets the last
    rank's): ``ppermute`` on the forward ring.  Every rank of the axis
    must call it with a tensor of the same shape and dtype."""
    d = axis_size(mesh, axis)
    if d == 1:
        return t
    group = mesh.get_group(axis)
    j = dist.get_rank(group)
    send = t.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, _peer(group, (j + 1) % d), group),
           dist.P2POp(dist.irecv, recv, _peer(group, (j - 1) % d), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def psum(t: torch.Tensor, mesh: DeviceMesh | None,
         axis: str = "shard") -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axis``, on every rank."""
    if mesh is None:
        return t
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return out


def pmean(t: torch.Tensor, mesh: DeviceMesh | None,
          axis: str = "shard") -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``axis``: ``psum`` / size."""
    return psum(t, mesh, axis) / axis_size(mesh, axis)


def broadcast(t: torch.Tensor, mesh: DeviceMesh | None, index: int,
              axis: str = "shard") -> torch.Tensor:
    """Rank ``index``'s ``t`` along ``axis``, on every rank of it (the
    others pass a tensor of the same shape and dtype)."""
    if mesh is None:
        return t
    group = mesh.get_group(axis)
    out = t.clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=_peer(group, index), group=group)
    return out


def all_to_all(t: torch.Tensor, mesh: DeviceMesh | None, split_dim: int,
               concat_dim: int, axis: str = "shard") -> torch.Tensor:
    """``jax.lax.all_to_all(t, axis, split_dim, concat_dim, tiled=True)``:
    ``split_dim`` is cut into d equal blocks, block j goes to axis index j,
    and the d blocks received are joined along ``concat_dim`` in axis
    index order (the index along ``axis``, not the global rank).  Every
    rank of the axis must call it with a tensor of the same shape and
    dtype; complex tensors travel as their real view."""
    d = axis_size(mesh, axis)
    if d == 1:
        return t
    n = t.dim()
    split_dim, concat_dim = split_dim % n, concat_dim % n
    if t.shape[split_dim] % d:
        raise ValueError(f"dimension {split_dim} ({t.shape[split_dim]}) is "
                         f"not a multiple of the axis size {d}")
    moved = t.movedim(split_dim, 0)
    send = moved.reshape(d, moved.shape[0] // d, *moved.shape[1:])
    send = send.contiguous()
    recv = torch.empty_like(send)
    if send.is_complex():
        dist.all_to_all_single(torch.view_as_real(recv),
                               torch.view_as_real(send),
                               group=mesh.get_group(axis))
    else:
        dist.all_to_all_single(recv, send, group=mesh.get_group(axis))
    # [d, block, rest...] -> the block back at split_dim, d just ahead of
    # concat_dim, then the two merged (d major)
    out = recv.movedim(1, split_dim + 1).movedim(0, concat_dim)
    shape = list(out.shape)
    shape[concat_dim:concat_dim + 2] = [shape[concat_dim]
                                        * shape[concat_dim + 1]]
    return out.reshape(shape)
