"""HostIngest in the port: the prefetch-threaded feed must give exactly the
outputs and carry of a direct step loop over the same frames (the step is
deterministic, so equality is exact), on the CPU and on a card."""

import numpy as np
import pytest
import torch

from clenabled_tpu_torch import pipelines as P
from clenabled_tpu_torch.streaming import HostIngest, HostIngestStats

N = 1 << 14
CFG = P.FxPipelineConfig(num_antennas=4, num_channels=16, samples_per_step=N)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _frames(k, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((4, N)).astype(np.float32),
             rng.standard_normal((4, N)).astype(np.float32)) for _ in range(k)]


def _ingest_vs_loop(device):
    fn, (_, _, tr0, ti0) = P.make_fx_pipeline_fused(CFG, device=device)

    def step(carry, xr, xi):
        fd, xre, xim, ntr, nti = fn(xr, xi, carry[0], carry[1])
        return (ntr, nti), (fd, xre, xim)

    frames = _frames(5)
    got = []
    ing = HostIngest(step, (tr0, ti0), N, prefetch=2, fetch_every=1,
                     device=device)
    stats = ing.run(iter(frames), on_outputs=lambda k, o: got.append((k, o)))
    assert isinstance(stats, HostIngestStats)
    assert stats["steps"] == 5 and stats["samples"] == 5 * N
    assert stats.msps > 0
    carry = (tr0, ti0)
    for k, (xr, xi) in enumerate(frames):
        carry, want = step(carry, torch.from_numpy(xr).to(device),
                           torch.from_numpy(xi).to(device))
        assert got[k][0] == k + 1
        for g, w in zip(got[k][1], want):
            assert g.device.type == "cpu"
            assert torch.equal(g, w.cpu())
    for g, w in zip(ing.carry, carry):
        assert torch.equal(g, w)


def test_host_ingest_matches_direct_loop_cpu():
    _ingest_vs_loop("cpu")


def test_host_ingest_single_arrays_and_n_steps():
    seen = []

    def step(carry, x):
        seen.append(x)
        return carry + x.sum(), x.mean()

    xs = [np.full(8, i, np.float32) for i in range(6)]
    ing = HostIngest(step, torch.zeros(()), 8, device="cpu")
    stats = ing.run(iter(xs), n_steps=4)
    assert stats["steps"] == 4 and len(seen) == 4
    assert float(ing.carry) == 8 * (0 + 1 + 2 + 3)


def test_host_ingest_reraises_feed_errors():
    def bad_frames():
        yield (np.zeros(4, np.float32),)
        raise RuntimeError("feed broke")

    ing = HostIngest(lambda c, x: (c, x), None, 4, device="cpu")
    with pytest.raises(RuntimeError, match="feed broke"):
        ing.run(bad_frames())


@pytest.mark.cuda
def test_host_ingest_matches_direct_loop_on_card(card):
    _ingest_vs_loop(card)
