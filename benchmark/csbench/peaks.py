"""Published peaks of the cards the benchmark runs on (data sheets; dense
rates, no sparsity). A roofline share is stated against these, with the
card's power limit printed beside it (a card set below its full limit runs
slower under load)."""

from __future__ import annotations

__all__ = ["PEAKS", "peaks_for", "least_seconds"]

# NVIDIA H100 SXM (80 GB HBM3), at 700 W: FP32 outside the tensor cores,
# HBM3 bandwidth, and the special-function units: 16 results (an exp2, a
# log2, a reciprocal, a square root) per SM and clock, 132 SMs at the
# 1,980 MHz boost clock
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flop_s": 67e12, "bytes_s": 3.35e12,
                              "sfu_s": 16 * 132 * 1.98e9},
}


def peaks_for(kind: str) -> dict | None:
    """The peaks of the card named ``kind`` (torch.cuda.get_device_name), or
    None for a card the table does not hold (its rooflines then read
    nothing)."""
    return PEAKS.get(kind)


def least_seconds(peaks: dict, flop: float = 0.0, sfu: float = 0.0,
                  nbytes: float = 0.0) -> float:
    """The least time the card could take for the work: the largest of its
    FP32 operations, special-function results and bytes at their peaks."""
    return max(flop / peaks["fp32_flop_s"], sfu / peaks["sfu_s"], nbytes / peaks["bytes_s"])
