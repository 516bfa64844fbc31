"""Device listing — the reference's clview (lib/clview.cc:43-246, which
prints platform ids, clock, compute units, workgroup limits, fp64/FMA/SVM):
each visible card's name, compute capability, SM count, memory, clocks and
power limit, the default mesh and the complex64 capability.

    python -m clenabled_tpu_torch.tools.clview [--cpu]

Without a card it exits non-zero unless ``--cpu`` asks for the CPU view.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="device info (clview)")
    ap.add_argument("--cpu", action="store_true", help="list the CPU")
    args = ap.parse_args(argv)

    import torch

    from clenabled_tpu_torch.runtime.device import (device_info, get_context,
                                                    supports_complex)

    kind = "cpu" if args.cpu else "cuda"
    if kind == "cuda" and not torch.cuda.is_available():
        raise SystemExit("clview lists CUDA cards; none is visible "
                         "(--cpu lists the CPU)")
    infos = device_info(kind)
    print(f"Devices: {len(infos)}")
    for i in infos:
        if i["platform"] == "cpu":
            print(f"  [{i['id']}] cpu  {i['name']}  cores={i['cores']}  "
                  f"torch threads={i['threads']}")
            continue
        line = (f"  [{i['id']}] gpu  {i['name']}  "
                f"sm_{i['compute_capability'].replace('.', '')}  "
                f"SMs={i['sm_count']}  "
                f"memory={i['memory_bytes'] / 2 ** 30:.1f}GiB "
                f"(free {i['mem_free_bytes'] / 2 ** 30:.1f}GiB)")
        if i.get("clocks_max_sm") is not None:
            line += (f"  sm clock={i['clocks_sm']:.0f}/"
                     f"{i['clocks_max_sm']:.0f} MHz  mem clock="
                     f"{i['clocks_mem']:.0f}/{i['clocks_max_mem']:.0f} MHz  "
                     f"power limit={i['power_limit']} W")
        print(line)
    ctx = None if kind == "cpu" else get_context()
    if ctx is not None:
        print(f"Default mesh: {ctx.num_devices} rank(s) on {ctx.platform} "
              f"({ctx.device})")
    print(f"complex64 supported: {supports_complex()}")
    return {"devices": infos, "complex": supports_complex()}


if __name__ == "__main__":
    main()
