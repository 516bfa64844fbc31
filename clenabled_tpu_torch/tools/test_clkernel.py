"""Custom-kernel harness — the reference's test-clkernel
(lib/test-clkernel.cc): load a user kernel file and function name, run it
and time it.  The kernel file is a Python module defining a torch function
(``clenabled_tpu_torch/examples/`` holds the reference's four examples);
``--1to1``/``--2to1`` and the dtype flags mirror the reference CLI.

    python -m clenabled_tpu_torch.tools.test_clkernel --1to1 --complex \\
        --kernelfile=clenabled_tpu_torch/examples/kernel1to1_sincos.py \\
        --fnname=sincos 2097152

Inputs are made on the host from fixed seeds (complex64 by default,
float32 with ``--float``, an int32 ramp with ``--int``) and moved to the
first CUDA card (``--cpu``: the CPU); timing as in ``tools/_timing``.
Returns the inputs and the kernel's output on them as numpy arrays.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    from clenabled_tpu_torch.tools import _timing as T

    ap = argparse.ArgumentParser(description="user kernel benchmark")
    ap.add_argument("--kernelfile", required=True)
    ap.add_argument("--fnname", required=True)
    ap.add_argument("--2to1", dest="two_to_one", action="store_true")
    ap.add_argument("--1to1", dest="one_to_one", action="store_true")
    ap.add_argument("--complex", dest="dtype_complex", action="store_true")
    ap.add_argument("--float", dest="dtype_float", action="store_true")
    ap.add_argument("--int", dest="dtype_int", action="store_true")
    ap.add_argument("blocksize", nargs="?", type=int, default=8192)
    ap.add_argument("--iterations", type=int, default=200)
    T.add_device_args(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    import numpy as np
    import torch

    from clenabled_tpu_torch.blocks.core import _load_fn_from_file
    from clenabled_tpu_torch.tools import _timing as T

    dev = T.select_device(args)
    fn = _load_fn_from_file(args.kernelfile, args.fnname)
    n = args.blocksize
    if args.dtype_float:
        def mk(s):
            return T.rand_float(n, s)
    elif args.dtype_int:
        def mk(s):
            return np.arange(n, dtype=np.int32)
    else:
        def mk(s):
            return T.rand_complex(n, s)

    host = [mk(i) for i in range(2 if args.two_to_one else 1)]
    inputs = [torch.from_numpy(h).to(dev) for h in host]
    print(f"platform: {T.platform_banner(dev)}", flush=True)
    secs = T.time_fn(fn, *inputs, iterations=args.iterations, device=dev,
                     percall=args.percall)
    rec = T.report(f"{args.fnname} ({args.kernelfile})", n, secs)
    rec.update(inputs=host, output=fn(*inputs).cpu().numpy())
    return rec


if __name__ == "__main__":
    main()
