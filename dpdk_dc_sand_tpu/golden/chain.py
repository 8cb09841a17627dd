"""Golden F chain and the int8-code comparison the engines are held to.

:func:`f_planes` runs the reference F-engine chain (coarse delay → PFB →
fine delay → requantise) on the host for the first spectra of a step, the
oracle for the device's int8 (re, im) planes. A device FFT sums in another
order than numpy, so values that land on a requantisation rounding
boundary can move by one code: :func:`check_codes` bounds both the size
of a difference and how often one occurs.
"""

from __future__ import annotations

import numpy as np

from dpdk_dc_sand_tpu.golden.delay import apply_fine_delay, coarse_delay
from dpdk_dc_sand_tpu.golden.pfb import pfb_channelise, pfb_window
from dpdk_dc_sand_tpu.golden.requant import requantise

#: At most this many codes apart anywhere ...
MAX_CODE_DIFF = 1
#: ... and at most this share of codes differing at all.
MAX_CODE_FRAC = 2e-3


def f_planes(
    adc: np.ndarray,
    coarse_delays: np.ndarray,
    frac_delays: np.ndarray,
    phases: np.ndarray,
    *,
    n_taps: int,
    n_channels: int,
    n_spectra: int,
    quant_scale: float,
) -> np.ndarray:
    """Golden int8 planes ``[A, P, n_spectra, C, 2]`` for one step's input.

    ``adc`` is ``[A, P, n]`` int8 as the engines take it; only the samples
    the first ``n_spectra`` spectra need are channelised.
    """
    fft = 2 * n_channels
    window = pfb_window(n_taps, fft)
    need = (n_spectra + n_taps - 1) * fft
    out = np.empty(adc.shape[:2] + (n_spectra, n_channels, 2), np.int8)
    for a in range(adc.shape[0]):
        stream = coarse_delay(adc[a], int(coarse_delays[a]))[..., :need]
        spectra = pfb_channelise(stream.astype(np.float32), window)
        rotated = apply_fine_delay(
            spectra, frac_delays[a], phases[a], n_channels
        )
        out[a] = requantise(rotated, quant_scale)
    return out


def code_mismatch(got: np.ndarray, want: np.ndarray) -> tuple[int, float]:
    """(largest code difference, share of codes that differ)."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(diff.max()), float(np.count_nonzero(diff)) / diff.size


def check_codes(
    got: np.ndarray,
    want: np.ndarray,
    max_code: int = MAX_CODE_DIFF,
    max_frac: float = MAX_CODE_FRAC,
) -> tuple[int, float]:
    """Raise ``AssertionError`` unless ``got`` is within the code budget.

    Returns :func:`code_mismatch` of the two arrays.
    """
    if got.shape != want.shape:
        raise AssertionError(f"shape {got.shape} != {want.shape}")
    worst, frac = code_mismatch(got, want)
    if worst > max_code or frac > max_frac:
        raise AssertionError(
            f"int8 codes differ by up to {worst} (limit {max_code}) in "
            f"{frac:.3g} of values (limit {max_frac})"
        )
    return worst, frac
