"""Custom user kernel — the reference's examples/kernel1to1_sincos.cl (a
user-supplied OpenCL kernel file loaded by clKernel1To1), as a user torch
function loaded by Kernel1To1 via the same (filename, kernelFnName) pair,
or passed directly as a callable:

    from clenabled_tpu_torch.examples import kernel1to1_sincos as k
    blocks.Kernel1To1(filename=k.__file__, kernelFnName="sincos")

    python -m clenabled_tpu_torch.tools.test_clkernel --1to1 --complex \\
        --kernelfile=clenabled_tpu_torch/examples/kernel1to1_sincos.py \\
        --fnname=sincos
"""

import torch


def sincos(x):
    """Per-sample sin(re) + j·cos(im) — the .cl example's intent."""
    return torch.complex(torch.sin(x.real), torch.cos(x.imag)).to(
        torch.complex64)


def main(device: str = "cuda"):
    """Run the kernel in a flowgraph on ``device`` (the card by default)."""
    import numpy as np

    from clenabled_tpu_torch import blocks
    from clenabled_tpu_torch.streaming import Flowgraph

    k = blocks.Kernel1To1(filename=__file__, kernelFnName="sincos")
    g = Flowgraph()
    g.external_input(k)
    tap = g.tap(k, name="out")
    r = g.compile(frame_size=1024, device=device)
    x = (np.linspace(0, np.pi, 1024) + 1j * np.linspace(0, np.pi, 1024)
         ).astype(np.complex64)
    out = r.step(x)[tap].cpu().numpy()
    print("custom kernel output[0:3]:", out[:3])


if __name__ == "__main__":
    main()
