"""Native C++ host runtime (ctypes bindings).

The port of ``clenabled_tpu.native``: the pieces of the reference's C++
runtime that stay on the host beside the card, from the same sources
(``native/src/``):

- :class:`RingBuffer` — SPSC lock-free byte ring (capture thread ↔ the
  thread that feeds the card; the role of GR buffers and the reference's
  pinned double buffers).
- ``unpack_4bit_planar``, ``unpack_i8_planar`` — packed-4-bit and
  signed-byte I/Q → planar float pairs; ``marshal_xengine_planar`` — the
  X-Engine's [time][station][chan][pol] marshal
  (lib/clXEngine_impl.cc:831-858, :982-1061 of gr-clenabled).
- :class:`RollingFileWriter` — rolling output files with JSON sidecars,
  written on a worker thread (lib/clXEngine_impl.cc:438-465).

The library is compiled with ``g++ -O3 -shared -fPIC -std=c++17`` at
first use into ``clenabled_tpu_torch/_build/`` (listed in ``.gitignore``),
under a name keyed by a hash of the sources and flags, written to a
temporary name first and moved into place, so that processes building at
once all load one whole library.  Unlike the JAX package's module there
is no numpy fallback: when the compiler fails, :func:`get_lib` raises with
its output.  The ``*_plain`` functions are the numpy forms the tests hold
the library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("ringbuffer.cc", "unpack.cc", "filewriter.cc")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None

_P = ctypes.c_void_p
_S = ctypes.c_size_t
# C entry points: (argument types, return type)
_SIGNATURES = {
    "rb_create": ([_S], _P),
    "rb_destroy": ([_P], None),
    "rb_write": ([_P, _P, _S], _S),
    "rb_read": ([_P, _P, _S], _S),
    "rb_available": ([_P], _S),
    "rb_space": ([_P], _S),
    "rb_capacity": ([_P], _S),
    "unpack_4bit_planar": ([_P, _P, _P, _S], None),
    "unpack_i8_planar": ([_P, _P, _P, _S], None),
    "deinterleave_c64": ([_P, _P, _P, _S], None),
    "interleave_c64": ([_P, _P, _P, _S], None),
    "marshal_xengine_planar": ([ctypes.POINTER(_P), _P, _S, _S, _S], None),
    "fw_create": ([ctypes.c_char_p, _S, ctypes.c_char_p], _P),
    "fw_write": ([_P, _P, _S], None),
    "fw_queue_depth": ([_P], _S),
    "fw_file_count": ([_P], ctypes.c_int),
    "fw_close": ([_P], None),
}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libclenabled_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists; raises
    ``RuntimeError`` with the compiler's output when g++ fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}"
                         ".tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp),
           *(str(SRC_DIR / s) for s in SOURCES), "-lpthread"]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found: {e}") from None
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def get_lib() -> ctypes.CDLL:
    """The native library, built on first use and loaded once; raises
    when it cannot be built (and again on every later call)."""
    global _lib, _build_error
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (RuntimeError, OSError) as e:
                _build_error = str(e)
                raise RuntimeError(f"native library unavailable: {e}") from e
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib, _build_error = lib, None
        return _lib


def build_error() -> str | None:
    """The last build's error, or None when the library loads."""
    try:
        get_lib()
    except RuntimeError:
        pass
    return _build_error


class RingBuffer:
    """SPSC byte ring buffer (capacity rounded up to a power of two); a
    full ring takes fewer bytes than offered instead of overwriting."""

    def __init__(self, capacity: int):
        self._lib = get_lib()
        self._h = self._lib.rb_create(capacity)
        if not self._h:
            raise MemoryError("rb_create failed")

    @property
    def capacity(self) -> int:
        return self._lib.rb_capacity(self._h)

    def available(self) -> int:
        return self._lib.rb_available(self._h)

    def space(self) -> int:
        return self._lib.rb_space(self._h)

    def write(self, data: np.ndarray) -> int:
        """Bytes of ``data`` written (fewer when the ring is full)."""
        data = np.ascontiguousarray(data)
        return self._lib.rb_write(self._h, data.ctypes.data, data.nbytes)

    def read(self, nbytes: int, dtype=np.uint8) -> np.ndarray:
        out = np.empty(nbytes, np.uint8)
        got = self._lib.rb_read(self._h, out.ctypes.data, nbytes)
        return out[:got].view(dtype)

    def close(self) -> None:
        if self._h:
            self._lib.rb_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


_TWOS = np.array([0, 1, 2, 3, 4, 5, 6, 7, 0, -7, -6, -5, -4, -3, -2, -1],
                 np.float32)


def unpack_4bit_planar(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Packed 4-bit I/Q bytes (high nibble I, low Q; two's complement, the
    code −8 read as 0) → (re, im) float32: each code times the float 1/7,
    bit for bit the device unpack ``xengine.unpack_packed_4bit_planar``."""
    lib = get_lib()
    raw = np.ascontiguousarray(raw, np.uint8).ravel()
    n = raw.size
    re = np.empty(n, np.float32)
    im = np.empty(n, np.float32)
    lib.unpack_4bit_planar(raw.ctypes.data, re.ctypes.data, im.ctypes.data, n)
    return re, im


def unpack_4bit_planar_plain(raw: np.ndarray):
    raw = np.asarray(raw, np.uint8).ravel()
    scale = np.float32(1.0 / 7.0)
    return _TWOS[raw >> 4] * scale, _TWOS[raw & 0xF] * scale


def unpack_i8_planar(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Interleaved signed-byte I/Q → (re, im) float32, scale 1/127."""
    lib = get_lib()
    raw = np.ascontiguousarray(raw, np.int8).ravel()
    n = raw.size // 2
    re = np.empty(n, np.float32)
    im = np.empty(n, np.float32)
    lib.unpack_i8_planar(raw.ctypes.data, re.ctypes.data, im.ctypes.data, n)
    return re, im


def unpack_i8_planar_plain(raw: np.ndarray):
    f = np.asarray(raw, np.int8).ravel().astype(np.float32) \
        * np.float32(1.0 / 127.0)
    n = f.size // 2
    return f[0:2 * n:2].copy(), f[1:2 * n:2].copy()


def marshal_xengine_planar(station_blocks, n_time: int,
                           chan_pol: int) -> np.ndarray:
    """[station][time·chan·pol] float32 blocks → [time, station,
    chan·pol]."""
    lib = get_lib()
    blocks = [np.ascontiguousarray(b, np.float32) for b in station_blocks]
    for b in blocks:
        if b.size < n_time * chan_pol:
            raise ValueError(f"a station block holds {b.size} values; "
                             f"{n_time} × {chan_pol} are read")
    s = len(blocks)
    out = np.empty((n_time, s, chan_pol), np.float32)
    ptrs = (_P * s)(*[b.ctypes.data for b in blocks])
    lib.marshal_xengine_planar(ptrs, out.ctypes.data, s, n_time, chan_pol)
    return out


def marshal_xengine_planar_plain(station_blocks, n_time: int, chan_pol: int):
    return np.stack([np.asarray(b, np.float32).ravel()[:n_time * chan_pol]
                     .reshape(n_time, chan_pol) for b in station_blocks], 1)


class RollingFileWriter:
    """Rolling binary writer with a JSON sidecar per file, written on a
    native worker thread: ``{base}_{index}.bin`` rolls over past
    ``rollover_bytes`` (0: never)."""

    def __init__(self, base: str, rollover_bytes: int = 0,
                 sidecar_json: str = ""):
        self._lib = get_lib()
        self._h = self._lib.fw_create(base.encode(), rollover_bytes,
                                      sidecar_json.encode())
        if not self._h:
            raise OSError(f"fw_create failed for {base!r}")

    def write(self, data: np.ndarray) -> None:
        data = np.ascontiguousarray(data)
        self._lib.fw_write(self._h, data.ctypes.data, data.nbytes)

    def queue_depth(self) -> int:
        return self._lib.fw_queue_depth(self._h)

    def file_count(self) -> int:
        return self._lib.fw_file_count(self._h)

    def close(self) -> None:
        """Drain the queue, close the last file."""
        if self._h:
            self._lib.fw_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
