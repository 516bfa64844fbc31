"""Custom user kernel — the reference's
examples/kernel1to1_multiply_const_float.cl (a user OpenCL kernel scaling
a float stream by 3.0, loaded by clKernel1To1 in float mode), as a user
torch function loaded by Kernel1To1 via the same (filename, kernelFnName)
pair:

    from clenabled_tpu_torch.examples import kernel1to1_multiply_const_float as k
    blocks.Kernel1To1(filename=k.__file__,
                      kernelFnName="multiply_float_const")

    python -m clenabled_tpu_torch.tools.test_clkernel --1to1 --float \\
        --kernelfile=clenabled_tpu_torch/examples/kernel1to1_multiply_const_float.py \\
        --fnname=multiply_float_const
"""

import torch


def multiply_float_const(x):
    """c[i] = a[i] * 3.0 on a float stream."""
    return (x * 3.0).to(torch.float32)


def main(device: str = "cuda"):
    """Run the kernel in a flowgraph on ``device`` (the card by default)."""
    import numpy as np

    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.streaming import Flowgraph

    k = blocks.Kernel1To1(filename=__file__,
                          kernelFnName="multiply_float_const")
    g = Flowgraph()
    g.external_input(k)
    tap = g.tap(k, name="out")
    r = g.compile(frame_size=1024, device=device)
    x = np.linspace(0, 1, 1024).astype(np.float32)
    out = r.step(x)[tap].cpu().numpy()
    print("multiply_float_const output[0:3]:", out[:3])


if __name__ == "__main__":
    main()
