"""Build and load the hand-written CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` (all started together)
and the objects are linked into one shared library with a plain C
interface, loaded with ctypes: each C function takes device
pointers, sizes and a stream, launches on that stream and returns
``cudaGetLastError()``.  The library is built at first use into
``clenabled_tpu_torch/_build/`` (listed in ``.gitignore``), under a name
keyed by a hash of the sources and flags, so a fresh checkout builds its
kernels the first time they are launched and a rebuilt source never loads a
stale library.  Only sources inside this package are compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: (argument types, return type)
_SIGNATURES = {
    "clen_fx_correlate": ([_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _I,
                           _I, _I, _I, _I, _P, _P, _P], _I),
    "clen_fx_smem_bytes": ([_I, _I, _I, _I], ctypes.c_longlong),
    "clen_pfb_packed": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "clen_pfb_smem_bytes": ([_I, _I, _I, _I], ctypes.c_longlong),
    "clen_xengine_gram": ([_P, _P, _I, _I, _I, _I, _I, _P, _P, _P], _I),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last load did: {"path", "built", "seconds", "log"}
last_build: dict = {}


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libclenabled_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: install the CUDA toolkit or set "
                       "CUDA_HOME")


def _run_all(cmds: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Run the commands concurrently; wait for every one of them."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    done = []
    for cmd, p in zip(cmds, procs):
        out, err = p.communicate()
        done.append(subprocess.CompletedProcess(cmd, p.returncode, out, err))
    return done


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills per
    kernel) and keeps the compiler's output in ``last_build["log"]``."""
    path = library_path()
    if path.exists() and not verbose:
        last_build.update(path=str(path), built=False, seconds=0.0, log="")
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    srcs = [s for s in sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    t0 = time.perf_counter()
    try:
        done = _run_all([[nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(o), str(s)]
                         for s, o in zip(srcs, objs)])
        if all(p.returncode == 0 for p in done):
            done += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)]])
        for proc in done:
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(proc.args)}"
                    f"\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    last_build.update(path=str(path), built=True,
                      seconds=time.perf_counter() - t0,
                      log="".join(p.stdout + p.stderr for p in done))
    return path


def load(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(verbose)))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
        return _lib
