"""The benchmark's arithmetic against hand counts and PERF.md's kernel
table."""

import math
import statistics

import pytest
import torch
from torch import nn

from benchmark import yardstick
from benchmark.reference.layers import GDN


def test_conv_transposed_conv_and_gdn_against_hand_counts():
    model = nn.Sequential(nn.Conv2d(3, 8, 5, stride=2, padding=2),
                          GDN(8),
                          nn.ConvTranspose2d(8, 4, 5, stride=2, padding=2,
                                             output_padding=1))
    with torch.device("meta"):
        model = model.to("meta")
        x = torch.empty(2, 3, 16, 24)
    total, gdns = yardstick.layer_flops(model, model, x)
    conv = 2 * 3 * 8 * 25 * (2 * 8 * 12)       # out pixels 8 x 12
    gdn = 2 * (2 * 8 * 12) * 8 * 8 + 4 * (2 * 8 * 12) * 8
    deconv = 2 * 8 * 4 * 25 * (2 * 8 * 12)     # in pixels 8 x 12
    assert total == conv + gdn + deconv
    assert gdns == [("gdn", 8, 2 * 8 * 12)]


def _step_ms(cost, rows=(262144, 65536, 16384), C=192):
    """A training step's six layers (GDN and IGDN at each of three
    resolutions), the larger bound of each launch, summed, in ms."""
    return 2e3 * sum(yardstick.bound_s(cost(n, C), 67e12, 3.35e12)
                     for n in rows)


def test_gdn_bounds_match_the_kernel_table():
    # PERF.md's kernel table at C = 192, f32: forward 0.765 (operations),
    # dx 1.538 (operations), partials 0.761 (operations), reduce 0.030
    # (bytes) ms a step; a q8 512x768 round trip 0.287 ms
    assert _step_ms(yardstick.gdn_fwd_cost) == pytest.approx(0.765, abs=5e-4)
    assert _step_ms(yardstick.gdn_dx_cost) == pytest.approx(1.538, abs=5e-4)
    assert _step_ms(yardstick.gdn_partials_cost) == pytest.approx(
        0.761, abs=5e-4)
    assert _step_ms(yardstick.gdn_reduce_cost) == pytest.approx(
        0.030, abs=5e-4)
    trip = _step_ms(yardstick.gdn_fwd_cost, rows=(98304, 24576, 6144))
    assert trip == pytest.approx(0.287, abs=5e-4)


def test_gdn_bytes_by_hand():
    n, C = 1000, 16
    k, t = math.ceil(n / 1024), math.ceil(n / 64)
    assert yardstick.gdn_fwd_cost(n, C)[1] == (2 * n * C + C * C + C) * 4
    assert yardstick.gdn_dx_cost(n, C)[1] == 3 * n * C * 4 + 4 * n * C \
        + (C * C + C) * 4
    assert yardstick.gdn_dx_cost(n, C, e=2)[1] == 3 * n * C * 2 \
        + 2 * n * C + 4 * t * C + (C * C + C) * 2
    assert yardstick.gdn_partials_cost(n, C)[1] == n * C * 4 + 4 * n * C \
        + 4 * k * (C * C + C)
    assert yardstick.gdn_reduce_cost(n, C)[1] == 4 * (k + 1) * (C * C + C)


def test_gdn_class_of_kernel_names():
    assert yardstick.gdn_class("gdn_fwd_f32_blocked_kernel") == "gdn_fwd"
    assert yardstick.gdn_class("gdn_bwd_dx_wide_kernel") == "gdn_bwd_dx"
    assert yardstick.gdn_class("gdn_bwd_partials_kernel") == \
        "gdn_bwd_partials"
    assert yardstick.gdn_class("gdn_bwd_reduce_kernel") == "gdn_bwd_reduce"
    assert yardstick.gdn_class("sm80_xmma_fprop") is None


@pytest.mark.parametrize("values", [[3.0, 1.0, 2.0], list(range(1, 112)),
                                    [5.5, 1.25, 9.0, 2.0, 7.75]])
def test_quantile_is_statistics_inclusive(values):
    want = statistics.quantiles(values, n=10, method="inclusive")[8]
    assert yardstick.quantile(values, 0.9) == pytest.approx(want)


def test_spread_is_iqr_over_median():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert yardstick.spread(v) == pytest.approx((q3 - q1) / q2)
