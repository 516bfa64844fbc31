"""The collectives of the sharded steps, on one axis of a ``DeviceMesh``.

JAX's ``shard_map`` collectives become ``torch.distributed`` calls on the
axis's process group, one rank a process:

- ``ring_forward`` is ``ppermute`` with the permutation [(j, (j+1) % d)]:
  one ``batch_isend_irecv`` of a send to the next rank and a receive from
  the previous one, peers mapped to global ranks with ``get_global_rank``;
- ``psum`` and ``pmean`` are ``all_reduce`` (sum, then a divide by d);
- ``broadcast`` from one rank of the axis stands where JAX masks every
  rank but one and takes a ``psum``: it is exact for every dtype.

``mesh=None`` is one rank with no process group: every collective is the
identity, as on a JAX mesh over one device.  At axis size 1 the ring hop
returns its input (gloo refuses a send to the own rank); the reductions
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
