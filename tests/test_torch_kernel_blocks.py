"""Port parity: the custom-kernel blocks ``Kernel1To1``/``Kernel2To1`` and
the package's ``exact_f32`` context.

The blocks run a user torch callable where JAX's run a JAX one: the port's
torch twins of the reference's two example kernels
(``clenabled_tpu_torch/examples/``), loaded from their files or passed as
callables, against JAX's blocks on JAX's example files
(``examples/*.py``), in flowgraphs on the same numpy feeds.  Complex
products are held within 1e-6 × max|ref|; the constant scale, exact in
both, bit for bit.
"""

import os

import numpy as np
import pytest
import torch

try:
    from clenabled_tpu import blocks as j_blocks
    from clenabled_tpu.streaming import Flowgraph as JFlowgraph
except ImportError:  # a card machine without JAX runs the card tests only
    j_blocks = None

import clenabled_tpu_torch
from clenabled_tpu_torch import blocks
from clenabled_tpu_torch.blocks import core as t_core
from clenabled_tpu_torch.dsp import hopper_kernels
from clenabled_tpu_torch.examples import kernel1to1_multiply_const_complex as ex1
from clenabled_tpu_torch.examples import kernel2to1_multiply_complex as ex2
from clenabled_tpu_torch.streaming import Flowgraph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_EX1 = os.path.join(ROOT, "examples", "kernel1to1_multiply_const_complex.py")
J_EX2 = os.path.join(ROOT, "examples", "kernel2to1_multiply_complex.py")
N = 1024


@pytest.fixture
def ref():
    if j_blocks is None:
        pytest.skip("needs JAX, the reference")


def _run(block, graph, feeds, **compile_kw):
    g = graph()
    for p in range(block.n_inputs):
        g.external_input(block, p)
    tap = g.tap(block, name="out")
    r = g.compile(frame_size=N, **compile_kw)
    return [np.asarray(r.step(*fr)[tap]) for fr in feeds]


def _feeds(n_inputs: int, seed: int, frames: int = 3):
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal(N) + 1j * rng.standard_normal(N)
              ).astype(np.complex64) for _ in range(n_inputs)]
            for _ in range(frames)]


@pytest.mark.parametrize("source", ["file", "callable"])
def test_kernel1to1_matches_jax(ref, source):
    if source == "file":
        blk = blocks.Kernel1To1(filename=ex1.__file__,
                                kernelFnName="multiply_const_complex")
    else:
        blk = blocks.Kernel1To1(ex1.multiply_const_complex)
    jblk = j_blocks.Kernel1To1(filename=J_EX1,
                               kernelFnName="multiply_const_complex")
    feeds = _feeds(1, 1)
    got = _run(blk, Flowgraph, feeds, device="cpu")
    want = _run(jblk, JFlowgraph, feeds)
    for g, w, fr in zip(got, want, feeds):
        assert g.dtype == w.dtype == np.complex64
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, fr[0] * np.float32(3.0))


@pytest.mark.parametrize("source", ["file", "callable"])
def test_kernel2to1_matches_jax(ref, source):
    if source == "file":
        blk = blocks.Kernel2To1(filename=ex2.__file__,
                                kernelFnName="multiply_complex")
    else:
        blk = blocks.Kernel2To1(ex2.multiply_complex)
    jblk = j_blocks.Kernel2To1(filename=J_EX2, kernelFnName="multiply_complex")
    feeds = _feeds(2, 2)
    got = _run(blk, Flowgraph, feeds, device="cpu")
    want = _run(jblk, JFlowgraph, feeds)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.complex64
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max())


def test_kernel_blocks_equal_math_blocks():
    """The example kernels equal MultiplyConst(3.0) and Multiply bit for
    bit (the check chip_smoke.py makes on the card)."""
    feeds1, feeds2 = _feeds(1, 3), _feeds(2, 4)
    for got, want in (
            (_run(blocks.Kernel1To1(ex1.multiply_const_complex), Flowgraph,
                  feeds1, device="cpu"),
             _run(blocks.MultiplyConst(3.0), Flowgraph, feeds1,
                  device="cpu")),
            (_run(blocks.Kernel2To1(ex2.multiply_complex), Flowgraph,
                  feeds2, device="cpu"),
             _run(blocks.Multiply(), Flowgraph, feeds2, device="cpu"))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_kernel_blocks_contract(ref):
    assert blocks.clKernel1To1 is blocks.Kernel1To1
    assert blocks.clKernel2To1 is blocks.Kernel2To1
    for mod in (blocks, j_blocks):
        assert mod.Kernel1To1.stateless and mod.Kernel2To1.stateless
        assert (mod.Kernel1To1.n_inputs, mod.Kernel2To1.n_inputs) == (1, 2)
        k = mod.Kernel1To1(lambda x: x, name="k", devSelector=1)
        assert k.name == "k"


@pytest.mark.parametrize("kwargs", [{}, {"filename": "x.py"},
                                    {"kernelFnName": "f"}])
def test_kernel_blocks_need_fn_or_file(ref, kwargs):
    for mod in (blocks, j_blocks):
        for cls in (mod.Kernel1To1, mod.Kernel2To1):
            with pytest.raises(ValueError,
                               match="pass fn, or filename \\+ kernelFnName"):
                cls(**kwargs)


def test_kernel_file_without_function_raises(ref):
    msgs = []
    for mod, path in ((blocks, ex1.__file__), (j_blocks, J_EX1)):
        with pytest.raises(ValueError, match="does not define") as e:
            mod.Kernel1To1(filename=path, kernelFnName="no_such_kernel")
        msgs.append(str(e.value).replace(path, "<file>"))
    assert msgs[0] == msgs[1] == "<file> does not define 'no_such_kernel'"


def test_example_mains_run(capsys):
    ex1.main(device="cpu")
    ex2.main(device="cpu")
    out = capsys.readouterr().out
    assert "multiply_const_complex output[0:3]" in out
    assert "custom 2:1 kernel ok" in out


# the root example scripts' twins
SCRIPTS = ("fft_xcorr", "fm_receiver", "streaming_ingest", "flagship",
           "xcorr_max_rate", "xcorr_test", "xengine_demo",
           "xengine_synchronized")


def test_examples_import_no_jax():
    import subprocess
    import sys

    code = ("import sys\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "import clenabled_tpu_torch.examples.kernel1to1_multiply_const_complex\n"
            "import clenabled_tpu_torch.examples.kernel2to1_multiply_complex\n"
            "import clenabled_tpu_torch.blocks\n"
            + "".join(f"import clenabled_tpu_torch.examples.{name}\n"
                      for name in SCRIPTS) +
            "bad = sorted(k for k in sys.modules if k in ('jax', "
            "'clenabled_tpu') "
            "or k.startswith(('jax.', 'jaxlib', 'clenabled_tpu.')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def tf32_on():
    """TF32 on for both libraries during the test, the flags restored
    after."""
    old = _flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def test_exact_f32_turns_tf32_off_and_restores(tf32_on):
    with clenabled_tpu_torch.exact_f32():
        assert _flags() == (False, False)
    assert _flags() == (True, True)


def test_exact_f32_restores_on_exception(tf32_on):
    with pytest.raises(RuntimeError, match="inside"):
        with clenabled_tpu_torch.exact_f32():
            raise RuntimeError("inside")
    assert _flags() == (True, True)


def test_exact_f32_nests(tf32_on):
    torch.backends.cudnn.allow_tf32 = False        # mixed flags come back
    with clenabled_tpu_torch.exact_f32():
        with clenabled_tpu_torch.exact_f32():
            assert _flags() == (False, False)
        assert _flags() == (False, False)
    assert _flags() == (True, False)


def test_full_f32_is_exact_f32():
    """The kernels' private context is the public one: one body sets the
    flags."""
    assert hopper_kernels._full_f32 is clenabled_tpu_torch.exact_f32


def test_load_fn_from_file(tmp_path):
    path = tmp_path / "k.py"
    path.write_text("import torch\n\ndef twice(x):\n    return x * 2\n")
    fn = t_core._load_fn_from_file(str(path), "twice")
    assert torch.equal(fn(torch.arange(3)), torch.tensor([0, 2, 4]))
