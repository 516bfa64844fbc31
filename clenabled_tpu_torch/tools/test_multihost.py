"""Multi-host validation: ``--procs`` launcher processes ("hosts") of
``--ranks-per-proc`` ranks each join one world through a TCP store on
127.0.0.1 (``sharding.spawn(..., procs=)``), build the global ``"shard"``
mesh over all of them and run one complex64 sharded FX step
(``pipelines.make_sharded_fx_pipeline``: 4 antennas, 512 samples a rank,
16 channels) on the same seeded global frame (``entry.multihost_rank``).
Rank 0 holds the step to the unsharded ``make_fx_pipeline`` over the
joined frame within 1e-4 × max|ref| (TF32 off: ``exact_f32``); every
rank's outputs must equal rank 0's.

    python -m clenabled_tpu_torch.tools.test_multihost --procs 2 \\
        --ranks-per-proc 2 [--device cuda|cpu]

This is the multi-host code path (a rendezvous address, ranks of
several launchers in one group, collectives across them) on one machine:
``--device cuda`` needs a card a rank (NCCL), ``--device cpu`` runs gloo.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="multi-host sharded step")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--ranks-per-proc", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from clenabled_tpu_torch.entry import multihost_run

    results, worst, differ = multihost_run(args.procs, args.ranks_per_proc,
                                           args.device)
    for r in results:
        print(f"[rank {r['rank']}/{r['world']} on {r['device']}] fd "
              f"{r['out'][0].shape} xmat {r['out'][1].shape} hist "
              f"{r['out'][2].shape}")
    if differ:
        raise SystemExit(f"ranks {differ}: outputs differ from rank 0")
    ok = worst <= 1.0
    print(f"multi-host run: {args.procs} launchers x {args.ranks_per_proc} "
          f"ranks, rank 0 within {worst:.4f} x tolerance of the unsharded "
          f"step: {'PASS' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(1)
    return {"procs": args.procs, "ranks_per_proc": args.ranks_per_proc,
            "device": args.device, "worst_over_tol": worst,
            "results": results}


if __name__ == "__main__":
    main()
