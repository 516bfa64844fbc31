"""``roofline.py`` reproduces the bounds the records hold: 0.0814 ms for
the fused FX step at 4 × 2^23 samples, 16 channels, 400 taps (by
operations) and 0.1703 ms for the int8 Gram over [256, 8192, 128] (by
bytes)."""

from benchmark import roofline


def test_fx_bound():
    ms, by = roofline.fx_bound(1 << 23, 1024, 16, 25, 4, 3, 10, 4)
    assert (round(ms, 4), by) == (0.0814, "operations")


def test_fx_bound_dense_and_wide():
    # the dense-DFT count and a 64-channel step, as the records hold them
    ops = roofline.fx_ops(1 << 23, 16, 25, 4, 3, 10, fft=False)
    assert round(ops / roofline.FP32_OPS * 1e3, 4) == 0.1760
    ms, _ = roofline.fx_bound(1 << 23, 2048, 64, 25, 4, 3, 10, 4)
    assert round(ms, 4) == 0.0901


def test_gram_bound():
    ms, by = roofline.gram_bound(256, 8192, 128, 1)
    assert (round(ms, 4), by) == (0.1703, "bytes")
    ms, by = roofline.gram_bound(16, 8192, 512, 1)
    assert (round(ms, 4), by) == (0.0694, "operations")
