"""Roofline accounting for compiled train steps: XLA-reported FLOPs and
device-memory bytes per step, against the card's published peaks.

The reference framework never reports absolute utilisation — its throughput
claims are relative to other torch runs. Here a benchmark line can carry
``mfu_pct`` (model FLOP utilisation vs the dense bf16 tensor-core peak) and
``hbm_bw_util_pct`` (achieved bytes/s vs peak memory bandwidth), computed
from the *compiled executable's own* cost analysis
(``Compiled.cost_analysis()``), not hand-derived estimates.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax

# Published peaks per card: (dense bf16 tensor-core FLOP/s, HBM bytes/s),
# keyed by the ``device_kind`` JAX reports. Source: NVIDIA H100 data sheet,
# SXM part, dense rates without sparsity, at the full 700 W power limit
# (989 TFLOP/s bf16, 3.35 TB/s HBM3). A card set below 700 W cannot hold
# its top clock, so report the power limit beside any share of these.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
}


def device_peaks(device=None) -> Dict[str, float]:
    """Published peaks of ``device`` (default: JAX's first device).

    Raises ``KeyError`` for a device kind the table does not list: a
    utilisation against a guessed peak would be a wrong number, not a
    missing one."""
    device = device or jax.devices()[0]
    kind = getattr(device, "device_kind", "")
    if kind not in _PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(_PEAKS)}")
    flops, bw = _PEAKS[kind]
    return {"device_kind": kind, "peak_flops": flops, "peak_hbm_bw": bw}


def compiled_cost(jitted_fn, *args) -> Optional[Dict[str, float]]:
    """Lower+compile ``jitted_fn`` for ``args`` and return XLA's own
    {'flops', 'bytes'} totals for one invocation, or None when the backend
    reports no cost analysis. Lowering never executes the function, so
    donated ``args`` are not consumed."""
    ca = jitted_fn.lower(*args).compile().cost_analysis()
    d = ca[0] if isinstance(ca, (list, tuple)) else ca
    if not d:
        return None
    return {"flops": float(d.get("flops", 0.0)),
            "bytes": float(d.get("bytes accessed", 0.0))}


def step_utilisation(flops_per_step: float, bytes_per_step: float,
                     step_time_s: float, device=None) -> Dict[str, float]:
    """MFU and memory-bandwidth utilisation percentages for a measured step
    on ``device`` (raises for a device without published peaks)."""
    peaks = device_peaks(device)
    return {
        "flops_per_step": flops_per_step,
        "hbm_bytes_per_step": bytes_per_step,
        "step_time_us": step_time_s * 1e6,
        "device": peaks["device_kind"],
        "mfu_pct": 100.0 * flops_per_step / step_time_s / peaks["peak_flops"],
        "hbm_bw_util_pct": 100.0 * bytes_per_step / step_time_s / peaks["peak_hbm_bw"],
    }
