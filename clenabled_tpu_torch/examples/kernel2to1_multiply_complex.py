"""Custom 2-input user kernel — the reference's
examples/kernel2to1_multiply_complex.cl (a user OpenCL kernel computing
c = a·b per sample, loaded by clKernel2To1), as a user torch function of
two streams loaded by Kernel2To1 via the same (filename, kernelFnName)
pair, or passed directly as a callable:

    from clenabled_tpu_torch.examples import kernel2to1_multiply_complex as k
    blocks.Kernel2To1(filename=k.__file__, kernelFnName="multiply_complex")

    python -m clenabled_tpu_torch.examples.kernel2to1_multiply_complex
"""

import torch


def multiply_complex(a, b):
    """Per-sample complex product — the .cl kernel's
    (a_r·b_r − a_i·b_i) + j(a_r·b_i + a_i·b_r)."""
    return (a * b).to(torch.complex64)


def main(device: str = "cuda"):
    """Run the kernel in a flowgraph on ``device`` (the card by default)."""
    import numpy as np

    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.streaming import Flowgraph

    k = blocks.Kernel2To1(filename=__file__, kernelFnName="multiply_complex")
    g = Flowgraph()
    g.external_input(k, 0)
    g.external_input(k, 1)
    tap = g.tap(k, name="out")
    r = g.compile(frame_size=1024, device=device)
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
         ).astype(np.complex64)
    b = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)
         ).astype(np.complex64)
    out = r.step(a, b)[tap].cpu().numpy()
    np.testing.assert_allclose(out, a * b, rtol=1e-5)
    print("custom 2:1 kernel ok; output[0:3]:", out[:3])


if __name__ == "__main__":
    main()
