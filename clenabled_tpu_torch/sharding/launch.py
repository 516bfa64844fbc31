"""Start the ranks of a sharded run, one process each.

``spawn(fn, world_size, device, *args)`` starts ``world_size`` processes
with the ``spawn`` method; each brings up its rank
(``initialize_distributed``: NCCL on card ``rank`` for ``device="cuda"``,
gloo for ``"cpu"``) from a ``file://`` store in a fresh temporary
directory, so that concurrent runs never contend for a port, calls
``fn(*args)``, tears its rank down, and hands back what ``fn`` returned
with every tensor as a numpy array (bfloat16 as float32, which holds it
exactly).  ``fn`` is pickled by its import path: it must be a module-level
function of a module that the children can import (the children import
torch and what ``fn``'s module imports, nothing of the caller's
``__main__`` guard).  In ``fn``, ``runtime.get_context()`` gives the 1-D
``"shard"`` mesh over the ranks and this rank's device;
``sharding.make_mesh`` builds other shapes.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from clenabled_tpu_torch.sharding.mesh import BACKENDS, initialize_distributed


def _to_numpy(tree):
    """``tree`` with every tensor as a numpy array on the host (bfloat16
    as float32); tuples, lists and dicts keep their kind."""
    if torch.is_tensor(tree):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _rank_main(rank: int, fn, world_size: int, device: str, workdir: str,
               args: tuple) -> None:
    initialize_distributed(device, f"file://{workdir}/store", world_size,
                           rank)
    try:
        out = _to_numpy(fn(*args))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn, world_size: int, device: str, *args) -> list:
    """Run ``fn(*args)`` on every rank of a ``world_size``-rank group on
    ``device`` ("cuda": one card a rank, raising when fewer are visible;
    "cpu": gloo); returns each rank's result, rank by rank.  A rank that
    raises stops the others and raises here."""
    if device not in BACKENDS:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} ranks need {world_size} cards; "
                           f"{torch.cuda.device_count()} are visible")
    with tempfile.TemporaryDirectory(prefix="clen_ranks_") as workdir:
        mp.start_processes(_rank_main, args=(fn, world_size, device, workdir,
                                             args),
                           nprocs=world_size, join=True, start_method="spawn")
        results = []
        for rank in range(world_size):
            with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
