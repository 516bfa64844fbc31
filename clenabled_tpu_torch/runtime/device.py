"""Device and mesh core.

The port names its device explicitly everywhere (``device=`` arguments,
module buffers) and asks only two questions of the card: is it a Hopper
part (the kernels are built for ``sm_90a``), and what are its name and
power limit (recorded beside every measurement).  ``launched_kernels``
reads which kernels a call ran from ``torch.profiler``, ``device_time_ms``
their device time per call, ``host_ms`` the host time to enqueue a call.

The JAX package's shared mesh context (``DeviceContext``, ``get_context``,
``set_default_mesh``) holds a ``torch.distributed`` ``DeviceMesh`` here:
once a process group is up (``sharding.initialize_distributed``), the
default context is the 1-D ``"shard"`` mesh over it; without one it is a
single rank on ``cuda:0`` whose collectives are identities, as those of a
JAX mesh over one device are.
"""

from __future__ import annotations

import dataclasses
import subprocess
import threading
import time
from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh


def get_device(kind: str = "cuda") -> torch.device:
    """``cuda:0`` (raises when no card is visible) or ``cpu`` when asked."""
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"device kind must be 'cuda' or 'cpu', got {kind!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible")
    return torch.device("cuda", 0)


@dataclasses.dataclass
class DeviceContext:
    """Process-wide mesh context.

    Attributes:
      mesh: the ``DeviceMesh`` the sharded steps run over, or None for a
        single rank with no process group.
      platform: ``"gpu"`` or ``"cpu"``.
      device: this rank's device.
    """

    mesh: DeviceMesh | None
    platform: str
    device: torch.device

    @property
    def num_devices(self) -> int:
        return 1 if self.mesh is None else self.mesh.size()


_lock = threading.Lock()
_context: DeviceContext | None = None
_context_world = None     # the default process group the context was made on


def _world():
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() \
        else None


def mesh_device(mesh: DeviceMesh | None) -> torch.device:
    """This rank's device on ``mesh``: its current card for a CUDA mesh,
    the CPU for a CPU one, ``cuda:0`` for None (one rank, no group)."""
    if mesh is None:
        return get_device("cuda")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _context_of(mesh) -> DeviceContext:
    dev = mesh_device(mesh)
    return DeviceContext(mesh, "gpu" if dev.type == "cuda" else "cpu", dev)


def get_context() -> DeviceContext:
    """The shared context: the mesh ``set_default_mesh`` installed, else
    the 1-D ``"shard"`` mesh over the initialised process group (on the
    cards for NCCL, the CPU for gloo), else one rank on ``cuda:0`` (raises
    when no card is visible).  A context made before the process group
    was destroyed or replaced is made anew."""
    global _context, _context_world
    with _lock:
        world = _world()
        if _context is None or _context_world is not world:
            mesh = None
            if world is not None:
                from torch.distributed.device_mesh import init_device_mesh

                mesh = init_device_mesh(
                    "cuda" if dist.get_backend() == "nccl" else "cpu",
                    (dist.get_world_size(),), mesh_dim_names=("shard",))
            _context, _context_world = _context_of(mesh), world
        return _context


def set_default_mesh(mesh) -> DeviceContext:
    """Install ``mesh`` (e.g. a 2-D ``{"host", "shard"}`` mesh from
    ``sharding.make_mesh``) as the shared context."""
    global _context, _context_world
    with _lock:
        _context, _context_world = _context_of(mesh), _world()
        return _context


def require_hopper(device: torch.device | str = "cuda:0") -> tuple[int, int]:
    """Raise unless ``device`` is a CUDA card of compute capability 9.0."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible")
    cap = torch.cuda.get_device_capability(torch.device(device))
    if cap != (9, 0):
        raise RuntimeError(
            f"the port's kernels target sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} has compute capability "
            f"{cap[0]}.{cap[1]}")
    return cap


def per_device(array):
    """``get(device)``: the host ``array`` as a tensor on ``device``,
    uploaded on the first request for that device and kept (a pageable
    upload per call would stall the host behind the card)."""
    on: dict = {}

    def get(device) -> torch.Tensor:
        key = torch.device(device)
        if key not in on:
            on[key] = torch.as_tensor(array, device=key)
        return on[key]

    return get


def card_info() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def supports_complex() -> bool:
    """Capability probe (the role of GRCLBase's fp64/FMA probes,
    lib/GRCLBase.cpp:300-342): complex64 tensors run on the card and the
    CPU alike, so the complex blocks need no planar fallback here."""
    return True


def device_info(kind: str = "cuda") -> list[dict]:
    """Per-device capability summary, the role of ``clview``
    (lib/clview.cc:43-246: platform, clock, compute units, memory): for
    each visible card its name, compute capability, SM count, memory,
    clocks (from ``nvidia-smi``, None where it cannot be read) and
    ``torch.cuda.mem_get_info``; with ``kind="cpu"`` one entry for the
    host CPU.  Raises for ``"cuda"`` when no card is visible."""
    import os
    import platform

    if kind == "cpu":
        return [{"id": 0, "platform": "cpu",
                 "name": platform.processor() or platform.machine(),
                 "cores": os.cpu_count(),
                 "threads": torch.get_num_threads()}]
    get_device(kind)
    clocks = _smi_clocks()
    out = []
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        free, _ = torch.cuda.mem_get_info(i)
        out.append({"id": i, "platform": "gpu", "name": p.name,
                    "compute_capability": f"{p.major}.{p.minor}",
                    "sm_count": p.multi_processor_count,
                    "memory_bytes": p.total_memory, "mem_free_bytes": free,
                    **(clocks[i] if i < len(clocks) else {})})
    return out


def _smi_clocks() -> list[dict]:
    """Per card: SM and memory clocks (current and maximum, MHz) and the
    power limit, from ``nvidia-smi``; empty when it cannot be run."""
    keys = ("clocks.sm", "clocks.max.sm", "clocks.mem", "clocks.max.mem",
            "power.limit")
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(keys)}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return []
    rows = []
    for line in res.stdout.strip().splitlines():
        vals = [v.strip() for v in line.split(",")]
        rows.append({k.replace(".", "_"): _number(v)
                     for k, v in zip(keys, vals)})
    return rows


def _number(text: str):
    try:
        return float(text)
    except ValueError:
        return None


def _device_events(fn, least: int, tries: int):
    """(fn(), [(name, µs)] of the device events it ran), read from
    ``torch.profiler``.  The profiler can miss the first milliseconds of
    device work in a trace (late in a long process, now and then in a fresh
    one), so each trace opens with 30 ms of uncounted work, an elementwise
    kernel on a scratch tensor, and only the device events that start in a
    marked window around ``fn`` count.  A window holding fewer than
    ``least`` device events is taken again, ``fn`` called anew, up to
    ``tries`` times; the last take is returned.  The spans the profiler
    draws on the device around a collective (``nccl:all_reduce``) are not
    kernels and are left out."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.autograd.DeviceType.CUDA
    scratch = torch.zeros(1 << 16, device="cuda")
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.03:
                scratch.add_(1.0)
                torch.cuda.synchronize()
            with record_function("launched_kernels"):
                out = fn()
                torch.cuda.synchronize()
        events = prof.events()
        start = min(e.time_range.start for e in events
                    if e.name == "launched_kernels")
        window = [(e.name, e.time_range.elapsed_us()) for e in events
                  if e.device_type == cuda and e.name != "launched_kernels"
                  and not e.name.startswith("nccl:")
                  and e.time_range.start >= start]
        if len(window) >= least:
            break
    return out, window


def is_nccl_kernel(name: str) -> bool:
    """A kernel of ``_device_events`` that NCCL launched for a collective
    (``ncclDevKernel_*``)."""
    return name.removeprefix("void ").startswith("nccl")


def host_ms(fn, reps: int = 20, device: torch.device | str = "cuda") -> float:
    """Host time to enqueue one call of ``fn``: wall clock over ``reps``
    back-to-back calls after a warm-up (and a synchronise on a card),
    stopped before the card is waited for."""
    sync = torch.device(device).type == "cuda"
    fn()
    if sync:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueued = time.perf_counter() - t0
    if sync:
        torch.cuda.synchronize()
    return enqueued / reps * 1e3


def launched_kernels(fn, least: int = 1, tries: int = 3):
    """(fn(), the names of the device kernels it ran), from
    ``torch.profiler`` (``_device_events``: a window of fewer than
    ``least`` events is taken again, up to ``tries`` times)."""
    out, window = _device_events(fn, least, tries)
    return out, [name for name, _ in window]


def device_time_ms(fn, calls: int, tries: int = 3) -> float | None:
    """Device time per call of ``fn`` (one kernel launch a call) over
    ``calls`` back-to-back calls, from ``torch.profiler``
    (``_device_events``); None when no take holds an event for each
    call."""
    _, window = _device_events(lambda: [fn() for _ in range(calls)], calls,
                               tries)
    if len(window) < calls:
        return None
    return sum(us for _, us in window) / calls / 1e3
