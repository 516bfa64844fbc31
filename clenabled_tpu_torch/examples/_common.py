"""What the example scripts share: the tools' ``--cpu``/``--percall``
options, the device they name, and the host copy of a result."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from clenabled_tpu_torch.tools import _timing


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser described by the first line of ``doc``, with the
    tools' ``--cpu`` and ``--percall``."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    _timing.add_device_args(ap)
    return ap


def device(args, script: str) -> torch.device:
    """The first CUDA card, or the CPU for ``--cpu``; without a card and
    without ``--cpu`` the script exits non-zero with a message."""
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit(f"{script} runs on a CUDA card and none is visible "
                         f"(--cpu runs it on the CPU)")
    return _timing.select_device(args)


def host(t) -> np.ndarray:
    """A tensor's values as a NumPy array on the host."""
    return t.detach().cpu().numpy()
