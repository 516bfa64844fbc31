"""Custom user kernel — the reference's
examples/kernel1to1_multiply_const_complex.cl (a user OpenCL kernel
scaling a complex stream by 3.0, loaded by clKernel1To1), as a user torch
function loaded by Kernel1To1 via the same (filename, kernelFnName) pair:

    from clenabled_tpu_torch.examples import kernel1to1_multiply_const_complex as k
    blocks.Kernel1To1(filename=k.__file__,
                      kernelFnName="multiply_const_complex")

    python -m clenabled_tpu_torch.examples.kernel1to1_multiply_const_complex
"""

import torch


def multiply_const_complex(x):
    """c[i] = a[i] * 3.0 on a complex stream — the .cl example's
    per-work-item scale of the (real, imag) struct fields."""
    return (x * 3.0).to(torch.complex64)


def main(device: str = "cuda"):
    """Run the kernel in a flowgraph on ``device`` (the card by default)."""
    import numpy as np

    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.streaming import Flowgraph

    k = blocks.Kernel1To1(filename=__file__,
                          kernelFnName="multiply_const_complex")
    g = Flowgraph()
    g.external_input(k)
    tap = g.tap(k, name="out")
    r = g.compile(frame_size=1024, device=device)
    x = (np.linspace(0, 1, 1024) + 1j * np.linspace(1, 0, 1024)
         ).astype(np.complex64)
    out = r.step(x)[tap].cpu().numpy()
    print("multiply_const_complex output[0:3]:", out[:3])


if __name__ == "__main__":
    main()
