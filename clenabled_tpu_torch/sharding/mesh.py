"""Process-group bring-up and mesh construction over ``torch.distributed``.

The port of ``clenabled_tpu.sharding.mesh``: a JAX ``Mesh`` becomes a
``DeviceMesh`` over the ranks of the initialised process group, one rank a
process.  The caller always names the device: NCCL runs the ranks on the
cards, gloo on the CPU, and nothing switches from one to the other.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from clenabled_tpu_torch.runtime.device import get_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _backend(device: str) -> str:
    if device not in BACKENDS:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda":
        get_device("cuda")                # raises when no card is visible
    return BACKENDS[device]


def initialize_distributed(device: str, init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           timeout_s: float | None = None,
                           store: dist.Store | None = None) -> None:
    """Start this process's rank: NCCL for ``device="cuda"``, on card
    ``rank % cuda.device_count()`` (the ranks of a host fill its cards in
    order; ``LOCAL_RANK`` or ``RANK`` from the environment when ``rank``
    is None), gloo for ``"cpu"``.  ``init_method``, ``world_size`` and
    ``rank`` are ``torch.distributed.init_process_group``'s (None: read
    from the environment), e.g. ``file:///tmp/x/store`` or
    ``tcp://host:port``, or ``store``, a ``torch.distributed`` store to
    meet on in place of ``init_method``; ``timeout_s`` bounds the bring-up
    and every collective (None: torch's default)."""
    backend = _backend(device)
    kw = {}
    if timeout_s is not None:
        import datetime

        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if device == "cuda":
        local = rank if rank is not None else int(
            os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        index = local % torch.cuda.device_count()
        torch.cuda.set_device(index)
        kw["device_id"] = torch.device("cuda", index)
    if store is not None:
        kw["store"] = store
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, **kw)


def make_mesh(shape: dict[str, int] | None = None,
              device: str = "cuda") -> DeviceMesh:
    """A mesh over every rank of the initialised process group.  Default:
    1-D, axis ``"shard"``.  ``shape`` such as ``{"host": 2, "shard": 2}``
    builds a 2-D mesh (outer axis first); the product of its sizes must be
    the world size.  Raises without a card for ``device="cuda"``, without a
    process group, and when the group's backend is not the device's."""
    backend = _backend(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group: call initialize_distributed "
                           "first")
    if dist.get_backend() != backend:
        raise ValueError(f"a {device} mesh needs the {backend} backend; the "
                         f"process group runs {dist.get_backend()}")
    world = dist.get_world_size()
    shape = {"shard": world} if shape is None else dict(shape)
    if math.prod(shape.values()) != world:
        raise ValueError(f"mesh shape {shape} != {world} ranks")
    return init_device_mesh(device, tuple(shape.values()),
                            mesh_dim_names=tuple(shape))

