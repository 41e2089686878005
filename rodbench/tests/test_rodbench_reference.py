"""The plain references against closed forms and the reference's golden demo.
CPU, float64, small batches."""

import math

import pytest
import torch

from rodbench.reference import rod, statics

GOLDEN_Q = (0.799770, 0.0, 0.600307, 0.0)       # SURVEY.md section 4, demo qe, N=16
GOLDEN_R = (0.562673, 0.0, -0.745914)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_golden_demo_tip():
    q, r = rod.solve(torch.tensor([rod.DEMO_QE], dtype=torch.float64))
    assert torch.allclose(q[0, 0], torch.tensor(GOLDEN_Q, dtype=torch.float64), atol=1e-6)
    assert torch.allclose(r[0, 0], torch.tensor(GOLDEN_R, dtype=torch.float64), atol=1e-6)


def test_straight_rod():
    q, r = rod.solve(torch.zeros(2, 9, dtype=torch.float64))
    x = rod.cgl_points(16)[:-1]
    assert torch.allclose(q, torch.tensor([1.0, 0, 0, 0], dtype=torch.float64).expand_as(q),
                          atol=1e-14)
    assert torch.allclose(r[:, :, 0], x.expand(2, -1), atol=1e-14)
    assert float(r[:, :, 1:].abs().max()) < 1e-14


@pytest.mark.parametrize("k", [0.7, -1.9])
def test_constant_bending_closed_form(k):
    qe = torch.zeros(1, 9, dtype=torch.float64)
    qe[0, 3] = k                                  # K_y = k P_0 = k along the rod
    q, r = rod.solve(qe)
    x = rod.cgl_points(16)[:-1]
    q_ref = torch.stack([torch.cos(k * x / 2), 0 * x, torch.sin(k * x / 2), 0 * x], -1)
    r_ref = torch.stack([torch.sin(k * x) / k, 0 * x, (torch.cos(k * x) - 1) / k], -1)
    assert float((q[0] - q_ref).abs().max()) < 1e-11
    assert float((r[0] - r_ref).abs().max()) < 1e-11


def test_legendre_and_quadrature():
    x = torch.linspace(0.0, 1.0, 7, dtype=torch.float64)
    p = rod.legendre_table(x, 3)
    t = 2 * x - 1
    assert torch.allclose(p, torch.stack([t ** 0, t, 1.5 * t ** 2 - 0.5], -1))
    w = statics.cc_weights(16, 2.0)
    pts = rod.cgl_points(16, 2.0)
    for deg in range(16):
        exact = 2.0 ** (deg + 1) / (deg + 1)
        assert abs(float((w * pts ** deg).sum()) - exact) < 1e-13 * exact


def test_residual_vanishes_unloaded_and_balances_a_closed_form():
    f = torch.zeros(3, 3, dtype=torch.float64)
    assert float(statics.residual(torch.zeros(3, 9, dtype=torch.float64), f).abs().max()) < 1e-14
    # A tip force along the straight rod's axis bends nothing.
    f[:, 0] = torch.tensor([0.3, -0.2, 0.1], dtype=torch.float64)
    assert float(statics.residual(torch.zeros(3, 9, dtype=torch.float64), f).abs().max()) < 1e-14


def test_tf32_round():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, -1.0 - 2 ** -11, math.pi])
    assert statics.tf32_round(x).tolist() == [1.0 + 2 ** -10, 1.0, -1.0 - 2 ** -10, 3.140625]
