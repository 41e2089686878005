"""The roofline arithmetic: the same work counts as ``chip_smoke.py``, and no
share above 100% at the kernel times measured on the H100."""

import pathlib
import sys

import pytest

from rodbench.metrics import roofline

ROOT = pathlib.Path(__file__).resolve().parents[2]

# PERF.md section 6 kernel table (NVIDIA H100 80GB HBM3, 700 W): ms per call
# and back to back, N=16 (n1 = 15), na = ne = 3, B = 131072.
MEASURED = {"k1": (0.1262, 0.1054), "k2": (0.1576, 0.1115), "k3": (0.2771, 0.2409)}


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def counted(chip_smoke, monkeypatch, fn, *args):
    seen = []
    monkeypatch.setattr(chip_smoke, "bound", lambda *a: seen.append(a) or {})
    fn(*args)
    return seen[0]


@pytest.mark.parametrize("b,n1,iters,corr", [(131072, 15, 20, 20), (4096, 15, 16, 8),
                                             (1024, 31, 12, 20)])
def test_counts_equal_chip_smoke(chip_smoke, monkeypatch, b, n1, iters, corr):
    assert counted(chip_smoke, monkeypatch, chip_smoke.k1_bound, b, n1, 3, 3, iters) \
        == tuple(roofline.k1(b, n1, 3, 3, iters))
    assert counted(chip_smoke, monkeypatch, chip_smoke.k2_bound, b, n1, 9, 3, iters) \
        == tuple(roofline.k2(b, n1, 9, 3, iters))
    assert counted(chip_smoke, monkeypatch, chip_smoke.k3_bound, b, n1, 3, 3, iters, corr) \
        == tuple(roofline.k3(b, n1, 3, 3, iters, corr))


def test_shares_under_100_at_the_measured_kernel_times():
    b, n1 = 131072, 15
    work = {"k1": roofline.k1(b, n1, 3, 3, 20), "k2": roofline.k2(b, n1, 9, 3, 20),
            "k3": roofline.k3(b, n1, 3, 3, 20, 20)}
    for name, times in MEASURED.items():
        for ms in times:
            share = roofline.share_pct(work[name], ms * 1e-3)
            assert 0.0 < share < 100.0, (name, ms, share)


def test_bound_is_the_slowest_class():
    w = roofline.k3(1000, 15, 3, 3, 20, 20)
    parts = [2 * w.mat / roofline.TF32_PEAK, 2 * w.f32 / roofline.FP32_PEAK,
             2 * w.f64 / roofline.FP64_PEAK, w.bytes / roofline.HBM_RATE]
    assert roofline.bound_seconds(w) == max(parts)
    assert roofline.share_pct(w, 0.0) is None
    assert roofline.k1(2, 15, 3, 3, 4) * 3 == tuple(3 * x for x in roofline.k1(2, 15, 3, 3, 4))
