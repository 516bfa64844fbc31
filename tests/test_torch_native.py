"""The port's native host runtime (``clenabled_tpu_torch.native``): the
build from its own sources, the ring buffer, the rolling file writer, and
the unpack and marshal functions held to the JAX package's
``clenabled_tpu.native`` and to the port's torch unpack (the device-side
form) on the same bytes."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from clenabled_tpu_torch import native
from clenabled_tpu_torch.dsp import xengine as t_xengine


def test_native_builds_from_its_own_sources():
    lib = native.get_lib()
    assert native.build_error() is None
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert os.path.dirname(lib._name) == str(path.parent)
    assert sorted(p.name for p in native.SRC_DIR.glob("*.cc")) == sorted(
        native.SOURCES)


def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path):
    """No numpy fallback: a failing compile raises with g++'s output."""
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    for name in native.SOURCES:
        (tmp_path / name).write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_lib()
    assert "error" in native.build_error()


_BUILD_ONE = """
import sys
from clenabled_tpu_torch import native
native.BUILD_DIR = native.Path(sys.argv[1])
print(native.get_lib()._name)
"""


def test_concurrent_builds_yield_one_loadable_library(tmp_path):
    """Two processes building into an empty directory at once both load
    one whole library (temporary names, then os.replace)."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE,
                               str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=os.path.dirname(
                                  os.path.dirname(os.path.abspath(__file__))))
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    names = {o[0].strip() for o in outs}
    assert len(names) == 1
    assert [p.name for p in tmp_path.iterdir()] == [os.path.basename(
        names.pop())]


def test_ringbuffer_roundtrip():
    rb = native.RingBuffer(1 << 16)
    assert rb.capacity == 1 << 16
    data = np.arange(1000, dtype=np.float32)
    assert rb.write(data) == data.nbytes
    assert rb.available() == data.nbytes
    assert rb.space() == rb.capacity - data.nbytes
    np.testing.assert_array_equal(rb.read(data.nbytes, dtype=np.float32),
                                  data)
    assert rb.available() == 0
    rb.close()


def test_ringbuffer_wraparound_and_backpressure():
    rb = native.RingBuffer(1000)           # rounds to 1024
    assert rb.capacity == 1024
    chunk = np.arange(100, dtype=np.uint8)
    total = sum(rb.write(chunk) for _ in range(8))
    first = rb.read(300)
    np.testing.assert_array_equal(first, np.tile(chunk, 8)[:300])
    rb.write(chunk)                        # wraps past the end
    rest = rb.read(10 ** 6)
    np.testing.assert_array_equal(
        rest, np.concatenate([np.tile(chunk, 8)[300:total], chunk]))
    # a full ring takes what fits and refuses the rest
    assert rb.write(np.zeros(5000, np.uint8)) == rb.capacity
    assert rb.write(np.zeros(10, np.uint8)) == 0
    assert rb.space() == 0
    rb.close()


def test_unpack_4bit_equals_device_unpack_and_jax():
    """Every byte value, then random bytes: bit for bit the port's torch
    unpack and the numpy form; the JAX package's native LUT divides each
    code by 7 instead of multiplying by the float 1/7, which moves codes
    ±3 and ±6 by one unit in the last place."""
    from clenabled_tpu import native as j_native

    rng = np.random.default_rng(0)
    raw = np.concatenate([np.arange(256, dtype=np.uint8),
                          rng.integers(0, 256, 1 << 14, dtype=np.uint8)])
    re, im = native.unpack_4bit_planar(raw)
    dev = t_xengine.unpack_packed_4bit_planar(torch.from_numpy(raw))
    np.testing.assert_array_equal(re, dev.re.numpy())
    np.testing.assert_array_equal(im, dev.im.numpy())
    plain = native.unpack_4bit_planar_plain(raw)
    np.testing.assert_array_equal(re, plain[0])
    np.testing.assert_array_equal(im, plain[1])
    j_re, j_im = j_native.unpack_4bit_planar(raw)
    np.testing.assert_array_max_ulp(re, j_re, maxulp=1)
    np.testing.assert_array_max_ulp(im, j_im, maxulp=1)


def test_unpack_i8_equals_device_unpack_and_jax():
    from clenabled_tpu import native as j_native

    raw = np.random.default_rng(1).integers(-128, 128, 1 << 14,
                                            dtype=np.int8)
    re, im = native.unpack_i8_planar(raw)
    dev = t_xengine.unpack_char_planar(torch.from_numpy(raw))
    np.testing.assert_array_equal(re, dev.re.numpy())
    np.testing.assert_array_equal(im, dev.im.numpy())
    j_re, j_im = j_native.unpack_i8_planar(raw)
    np.testing.assert_array_equal(re, j_re)
    np.testing.assert_array_equal(im, j_im)
    plain = native.unpack_i8_planar_plain(raw)
    np.testing.assert_array_equal(re, plain[0])
    np.testing.assert_array_equal(im, plain[1])


def test_marshal_xengine_equals_jax():
    from clenabled_tpu import native as j_native

    t, s, cp = 8, 5, 6
    rng = np.random.default_rng(2)
    blocks = [rng.standard_normal(t * cp).astype(np.float32)
              for _ in range(s)]
    out = native.marshal_xengine_planar(blocks, t, cp)
    assert out.shape == (t, s, cp)
    np.testing.assert_array_equal(out, j_native.marshal_xengine_planar(
        blocks, t, cp))
    np.testing.assert_array_equal(
        out, native.marshal_xengine_planar_plain(blocks, t, cp))
    with pytest.raises(ValueError, match="station block"):
        native.marshal_xengine_planar([b[:-1] for b in blocks], t, cp)


def test_rolling_file_writer(tmp_path):
    base = str(tmp_path / "xout")
    sidecar = json.dumps({"channels": 256, "format": "triangular order"})
    w = native.RollingFileWriter(base, rollover_bytes=1000,
                                 sidecar_json=sidecar)
    chunk = np.arange(100, dtype=np.float32)          # 400 bytes
    for _ in range(6):                                # 3 files of 800
        w.write(chunk)
    deadline = time.time() + 5
    while w.queue_depth() > 0 and time.time() < deadline:
        time.sleep(0.01)
    w.close()
    bins = sorted(p for p in os.listdir(tmp_path) if p.endswith(".bin"))
    metas = sorted(p for p in os.listdir(tmp_path) if p.endswith(".json"))
    assert bins == [f"xout_{i}.bin" for i in range(3)]
    assert metas == [f"xout_{i}.json" for i in range(3)]
    assert sum(os.path.getsize(tmp_path / p) for p in bins) == 2400
    for m in metas:
        assert json.load(open(tmp_path / m))["channels"] == 256
    data = np.concatenate([np.fromfile(tmp_path / p, dtype=np.float32)
                           for p in bins])
    np.testing.assert_array_equal(data, np.tile(chunk, 6))
