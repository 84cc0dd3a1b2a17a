"""Roofline accounting (utils/roofline.py): XLA cost extraction, the H100
peak lookup and the utilisation arithmetic. A device without published
peaks is an error, never a silently missing field."""

import jax
import jax.numpy as jnp
import pytest

from news_recsys_tpu.utils.roofline import (compiled_cost, device_peaks,
                                            step_utilisation)


class FakeDev:
    def __init__(self, kind):
        self.device_kind = kind


def test_compiled_cost_matmul():
    def f(a, b):
        return (a @ b).sum()

    a = jnp.ones((64, 64), jnp.float32)
    cost = compiled_cost(jax.jit(f), a, a)
    assert cost is not None
    # 2*64^3 matmul FLOPs (+64^2 for the sum); XLA may fold some, so just
    # require the right order of magnitude and nonzero traffic
    assert cost["flops"] >= 2 * 64**3
    assert cost["bytes"] > 0


def test_device_peaks_unknown_on_cpu():
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(jax.devices("cpu")[0])


def test_device_peaks_h100():
    peaks = device_peaks(FakeDev("NVIDIA H100 80GB HBM3"))
    assert peaks == {"device_kind": "NVIDIA H100 80GB HBM3",
                     "peak_flops": 989e12, "peak_hbm_bw": 3.35e12}


def test_step_utilisation_known_chip():
    # 1 GFLOP + 1 MB in 1 ms on an H100: mfu = 1e12/989e12, bw = 1e9/3.35e12
    out = step_utilisation(1e9, 1e6, 1e-3, device=FakeDev("NVIDIA H100 80GB HBM3"))
    assert out["device"] == "NVIDIA H100 80GB HBM3"
    assert out["mfu_pct"] == pytest.approx(100 * 1e12 / 989e12)
    assert out["hbm_bw_util_pct"] == pytest.approx(100 * 1e9 / 3.35e12)
    assert out["step_time_us"] == pytest.approx(1000.0)


def test_step_utilisation_unknown_chip():
    with pytest.raises(KeyError):
        step_utilisation(1e9, 1e6, 1e-3, device=jax.devices("cpu")[0])
