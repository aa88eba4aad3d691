"""Integer CDF-table construction for the rANS coder.

A copy of lmic_tpu/ops/cdf.py (the port imports nothing of lmic_tpu); the
two must stay integer-identical, which tests/test_torch_ops.py checks.

Quantizes a floating-point pmf to a monotone integer CDF summing exactly to
2^precision, then repairs zero-width intervals by stealing frequency from the
lowest-frequency symbol. The integer semantics mirror the reference C++
(compressai/cpp_exts/ops/ops.cpp:40-109) so that CDF tables — and therefore
bitstreams — are reproducible:

  1. freq[i]   = round(pmf[i] * 2^p)            (float32 product, round half up)
  2. freq[i]   = (2^p * freq[i]) // total       (64-bit integer scaling)
  3. cdf       = prefix_sum(freq); cdf[-1] = 2^p
  4. for ascending i with cdf[i] == cdf[i+1]: steal 1 from the smallest
     freq > 1 (earliest such index wins ties), shifting the intervening
     cdf entries.

This runs on the host once per `update()` — a handful of rows of a few
thousand entries — so plain numpy + a small repair loop is the right tool;
the hot coding path consumes the resulting tables natively.
"""

from __future__ import annotations

import numpy as np


def pmf_to_quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    """Quantize one pmf row to an integer CDF of length `len(pmf) + 1`."""
    pmf = np.asarray(pmf, dtype=np.float32)
    if pmf.ndim != 1:
        raise ValueError("pmf must be 1-D")
    if np.any(~np.isfinite(pmf)) or np.any(pmf < 0):
        raise ValueError(
            "Invalid `pmf`, non-finite or negative element found"
        )

    one = np.int64(1) << precision
    # float32 product to match the reference's float arithmetic, then
    # round-half-up (== round-half-away-from-zero for non-negative input).
    scaled = (pmf * np.float32(one)).astype(np.float64)
    freq = np.floor(scaled + 0.5).astype(np.int64)

    total = int(freq.sum())
    if total == 0:
        raise ValueError(
            "Invalid `pmf`: at least one element must have a non-zero "
            "probability."
        )

    freq = (int(one) * freq) // total

    cdf = np.zeros(len(pmf) + 1, dtype=np.int64)
    np.cumsum(freq, out=cdf[1:])
    cdf[-1] = one

    _repair_zero_intervals(cdf)

    return cdf.astype(np.int32)


def _repair_zero_intervals(cdf: np.ndarray) -> None:
    """In-place zero-width interval repair (reference ops.cpp:74-100)."""
    n = len(cdf) - 1
    for i in range(n):
        if cdf[i] != cdf[i + 1]:
            continue
        freqs = np.diff(cdf)
        candidates = np.where(freqs > 1)[0]
        if len(candidates) == 0:
            raise ValueError("Cannot repair pmf: no symbol has frequency > 1")
        best_steal = candidates[np.argmin(freqs[candidates])]
        if best_steal < i:
            cdf[best_steal + 1 : i + 1] -= 1
        else:
            cdf[i + 1 : best_steal + 1] += 1


def batched_pmf_to_quantized_cdf(
    pmf: np.ndarray,
    tail_mass: np.ndarray,
    pmf_length: np.ndarray,
    max_length: int,
    precision: int = 16,
) -> np.ndarray:
    """Build a padded `(rows, max_length + 2)` int32 CDF table.

    Row i quantizes `concat(pmf[i, :pmf_length[i]], tail_mass[i])` — the
    per-row layout used by the entropy models (reference:
    compressai/entropy_models/entropy_models.py:206-214).
    """
    pmf = np.asarray(pmf)
    tail_mass = np.asarray(tail_mass).reshape(-1)
    pmf_length = np.asarray(pmf_length).reshape(-1).astype(np.int64)
    rows = len(pmf_length)
    out = np.zeros((rows, int(max_length) + 2), dtype=np.int32)
    for i in range(rows):
        n = int(pmf_length[i])
        prob = np.concatenate([pmf[i, :n], tail_mass[i : i + 1]])
        cdf = pmf_to_quantized_cdf(prob, precision)
        out[i, : len(cdf)] = cdf
    return out
