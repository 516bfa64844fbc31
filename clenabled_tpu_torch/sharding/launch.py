"""Start the ranks of a sharded run, one process each.

``spawn(fn, world_size, device, *args, procs=1)`` starts ``world_size``
rank processes with the ``spawn`` method.  With ``procs`` > 1 it starts
that many launcher processes (the "hosts"), each of which starts
``world_size // procs`` local ranks: rank ``proc · ranks_per_proc +
local``, as processes on separate hosts join one group through a
rendezvous address.  Every rank joins one world through a TCP store on
127.0.0.1 that the caller holds for the whole run, on a port the system
picked when the store was bound (port 0), so that concurrent runs never
contend for a port.  Each rank brings up its group
(``initialize_distributed``: NCCL on card ``rank`` for ``device="cuda"``,
gloo for ``"cpu"``), calls ``fn(*args)``, waits at a barrier for every
rank to finish, tears its rank down (``shutdown_distributed``: the
group's threads end before the process exits), and hands
back what ``fn`` returned with every tensor as a numpy array (bfloat16 as
float32, which holds it exactly).  ``fn`` is pickled by its import path:
it must be a module-level function of a module that the children can
import (the children import torch and what ``fn``'s module imports,
nothing of the caller's ``__main__`` guard).  In ``fn``,
``runtime.get_context()`` gives the 1-D ``"shard"`` mesh over the ranks
and this rank's device; ``sharding.make_mesh`` builds other shapes.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from clenabled_tpu_torch.sharding.mesh import (BACKENDS, initialize_distributed,
                                               shutdown_distributed)

TIMEOUT_S = 300.0      # the bring-up and every collective of a spawned run
HOST = "127.0.0.1"


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


def _rank_main(local: int, proc: int, ranks_per_proc: int, world: int,
               port: int, fn, device: str, workdir: str,
               args: tuple) -> None:
    rank = proc * ranks_per_proc + local
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    store = dist.TCPStore(HOST, port, world, is_master=False,
                          timeout=timeout)
    initialize_distributed(device, None, world, rank, timeout_s=TIMEOUT_S,
                           store=store)
    try:
        out = _to_numpy(fn(*args))
        dist.barrier()      # no rank tears down while a peer still uses a pair
    finally:
        shutdown_distributed()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _launcher(proc: int, ranks_per_proc: int, world: int, port: int, fn,
              device: str, workdir: str, args: tuple) -> None:
    """One launcher ("host"): start its local ranks and wait for them; a
    rank that raises stops the others and raises here."""
    mp.start_processes(_rank_main,
                       args=(proc, ranks_per_proc, world, port, fn, device,
                             workdir, args),
                       nprocs=ranks_per_proc, join=True,
                       start_method="spawn")


def _run_launchers(procs: int, launcher_args: tuple) -> None:
    """``procs`` launcher processes; the first that fails stops the others
    and raises here."""
    ctx = mp.get_context("spawn")
    hosts = [ctx.Process(target=_launcher, args=(p, *launcher_args))
             for p in range(procs)]
    for h in hosts:
        h.start()
    failed = None
    try:
        while failed is None and any(h.is_alive() for h in hosts):
            failed = next((h for h in hosts if h.exitcode not in (None, 0)),
                          None)
            time.sleep(0.05)
        failed = failed or next((h for h in hosts if h.exitcode), None)
    finally:
        for h in hosts:
            if h.is_alive():
                h.terminate()
            h.join()
    if failed is not None:
        raise RuntimeError(f"launcher {hosts.index(failed)} of {procs} "
                           f"exited with code {failed.exitcode}")


def spawn(fn, world_size: int, device: str, *args, procs: int = 1) -> list:
    """Run ``fn(*args)`` on every rank of a ``world_size``-rank group on
    ``device`` ("cuda": one card a rank, raising when fewer are visible;
    "cpu": gloo), started by ``procs`` launcher processes of
    ``world_size // procs`` ranks each (1: this process starts the ranks
    itself); returns each rank's result in global rank order.  A rank that
    raises stops the others and raises here."""
    if device not in BACKENDS:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if procs < 1 or world_size % procs:
        raise ValueError(f"{world_size} ranks do not split over {procs} "
                         f"launchers")
    if device == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} ranks need {world_size} cards; "
                           f"{torch.cuda.device_count()} are visible")
    # the store's port stays bound by this process until the run ends
    store = dist.TCPStore(HOST, 0, None, is_master=True,
                          timeout=datetime.timedelta(seconds=TIMEOUT_S),
                          wait_for_workers=False)
    with tempfile.TemporaryDirectory(prefix="clen_ranks_") as workdir:
        launcher_args = (world_size // procs, world_size, store.port, fn,
                         device, workdir, args)
        if procs == 1:
            _launcher(0, *launcher_args)
        else:
            _run_launchers(procs, launcher_args)
        results = []
        for rank in range(world_size):
            with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    del store
    return results
