"""Core array configuration and delay-model types.

This is the single source of truth for system shape parameters, unifying the
reference's four config tiers (SURVEY.md §5.6): compile-time macros
(``beamformer_coefficient_generator/BeamformerParameters.h:7-17``),
per-shape JIT template parameters
(``beamformer/beamforming/prebeamform_reorder.py:40-65``), CLI flags, and the
test-parameter module (``beamformer/unit_test/test_parameters.py``).

All shapes are static under ``jax.jit``; an :class:`ArrayConfig` is
hashable and used as a static argument, so each distinct configuration
compiles exactly once (the analog of the reference's per-shape mako builds).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

#: MeerKAT L-band digitiser rate (BeamformerParameters.h:16,
#: beamform_op_sequence_test.py:90).
ADC_SAMPLE_RATE = 1712e6

#: Polarisations are always 2 in the reference python pipeline
#: (prebeamform_reorder.py:53).
N_POLS = 2

#: Complex sample = (real, imag) pair (BeamformerParameters.h:4).
COMPLEXITY = 2


def _check_power_of_two(name: str, value: int) -> None:
    if value < 1 or value & (value - 1):
        raise ValueError(f"{name} must be a power of two, got {value}")


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """Frozen description of one correlator/beamformer configuration.

    Mirrors the parameter set threaded through the reference's op templates
    (``beamform_op_sequence.py:69-110``) and native macros
    (``BeamformerParameters.h:7-17``).

    Parameters
    ----------
    n_ants:
        Antennas in the array. Each produces ``n_pols`` polarisations.
    n_channels:
        Total FFT channels in the system ("n_channels out of the FFT",
        beamform_op_sequence.py:52). The per-engine channel count is derived,
        see :attr:`n_channels_per_stream`.
    n_beams:
        Beams steered by the B-engine.
    n_samples_per_channel:
        Time samples per channel per batch; 256 matches MeerKAT 1 KiB heaps
        (test_parameters.py:22-25).
    n_pols:
        Polarisations; the reference hardcodes 2.
    adc_sample_rate:
        Digitiser sample rate in Hz.
    sample_bitwidth:
        Bits per real sample component (8 throughout the reference).
    n_taps:
        Polyphase-filterbank prototype-filter taps (F-engine).
    n_batches:
        Independent matrices processed per invocation — the DP-style batch
        axis (prebeamform_reorder.py:36-37).
    """

    n_ants: int = 64
    n_channels: int = 1024
    n_beams: int = 16
    n_samples_per_channel: int = 256
    n_pols: int = N_POLS
    adc_sample_rate: float = ADC_SAMPLE_RATE
    sample_bitwidth: int = 8
    n_taps: int = 16
    n_batches: int = 1

    def __post_init__(self) -> None:
        _check_power_of_two("n_channels", self.n_channels)
        if self.n_samples_per_channel % self.n_samples_per_block:
            raise ValueError(
                "n_samples_per_channel must be divisible by "
                f"{self.n_samples_per_block}"
            )

    # ------------------------------------------------------------------
    # Derived geometry
    # ------------------------------------------------------------------
    @property
    def sample_period(self) -> float:
        """ADC sampling period in seconds (1/1712e6 for MeerKAT)."""
        return 1.0 / self.adc_sample_rate

    @property
    def complexity(self) -> int:
        return COMPLEXITY

    @property
    def n_samples_per_block(self) -> int:
        """Samples per time block: 128 bits / sample bitwidth.

        The reference blocks time into 16-sample groups shaped for
        tensor-core fragments (prebeamform_reorder.py:58-60); here the
        same 16-sample granule is the unit of the time axis used for
        time-shard boundaries.
        """
        return 128 // self.sample_bitwidth

    @property
    def n_blocks(self) -> int:
        return self.n_samples_per_channel // self.n_samples_per_block

    @property
    def n_channels_per_stream(self) -> int:
        """Channels owned by one engine.

        ``n_channels // n_ants // 4`` exactly as the reference computes it
        (beamform_op_sequence_test.py:85).
        """
        return self.n_channels // self.n_ants // 4

    @property
    def n_engines(self) -> int:
        """Engines needed to cover the whole band."""
        return self.n_channels // max(self.n_channels_per_stream, 1)

    @property
    def fft_size(self) -> int:
        """Real-FFT length producing ``n_channels`` channels (2·n_channels)."""
        return 2 * self.n_channels

    @property
    def window_size(self) -> int:
        """PFB FIR prototype filter length in samples."""
        return self.n_taps * self.fft_size

    def channel_offset(self, xeng_id: int) -> int:
        """Absolute first channel owned by engine ``xeng_id``.

        ``ichannel = ichannelindex + n_channels_per_stream * xeng_id``
        (coeff_generator.py:49-53).
        """
        return self.n_channels_per_stream * xeng_id

    # ------------------------------------------------------------------
    # Canonical array shapes (the IOSlot dimension specs of the reference,
    # prebeamform_reorder.py:67-85, coeff_generator.py:164-177)
    # ------------------------------------------------------------------
    @property
    def ingest_shape(self) -> Tuple[int, ...]:
        """[batch][ant][chan_per_stream][time][pol][cplx] u8 ingest layout."""
        return (
            self.n_batches,
            self.n_ants,
            self.n_channels_per_stream,
            self.n_samples_per_channel,
            self.n_pols,
            self.complexity,
        )

    @property
    def reordered_shape(self) -> Tuple[int, ...]:
        """[batch][pol][chan][block][t_in_block][ant][cplx] u8 layout."""
        return (
            self.n_batches,
            self.n_pols,
            self.n_channels_per_stream,
            self.n_blocks,
            self.n_samples_per_block,
            self.n_ants,
            self.complexity,
        )

    @property
    def delay_vals_shape(self) -> Tuple[int, ...]:
        """[chan_per_stream][beam][ant][4] f32 delay polynomial layout."""
        return (self.n_channels_per_stream, self.n_beams, self.n_ants, 4)

    @property
    def coeff_shape(self) -> Tuple[int, ...]:
        """[batch][pol][chan][2·ant][2·beam] f32 rotation-block layout."""
        return (
            self.n_batches,
            self.n_pols,
            self.n_channels_per_stream,
            2 * self.n_ants,
            2 * self.n_beams,
        )

    @property
    def beam_shape(self) -> Tuple[int, ...]:
        """[batch][pol][chan][block][t_in_block][2·beam] f32 output layout."""
        return (
            self.n_batches,
            self.n_pols,
            self.n_channels_per_stream,
            self.n_blocks,
            self.n_samples_per_block,
            2 * self.n_beams,
        )


@dataclasses.dataclass(frozen=True)
class DelayModel:
    """Per-(beam, antenna) delay polynomial, as supplied by CAM.

    The JAX form of ``struct delay_vals``
    (BeamformerParameters.h:61-66): first-order polynomials in time for both
    delay and phase. Arrays are ``[n_beams][n_ants]`` float32; they are
    *runtime inputs* to the jitted pipeline (never baked constants) so CAM
    updates at the reference's 256-accumulation cadence
    (BeamformerParameters.h:17) do not recompile anything.
    """

    delay_s: np.ndarray
    delay_rate_sps: np.ndarray
    phase_rad: np.ndarray
    phase_rate_radps: np.ndarray

    @classmethod
    def zeros(cls, n_beams: int, n_ants: int) -> "DelayModel":
        z = np.zeros((n_beams, n_ants), np.float32)
        return cls(z, z.copy(), z.copy(), z.copy())

    @classmethod
    def from_delay_vals(cls, delay_vals: np.ndarray) -> "DelayModel":
        """Build from the reference's ``[chan][beam][ant][4]`` layout.

        The reference stores identical polynomial values for every channel
        (beamform_op_sequence_test.py:92-101); channel 0's values are taken
        as canonical.
        """
        dv = np.asarray(delay_vals, np.float32)
        if dv.ndim == 4:
            dv = dv[0]
        return cls(dv[..., 0], dv[..., 1], dv[..., 2], dv[..., 3])

    def to_delay_vals(self, n_channels_per_stream: int) -> np.ndarray:
        """Expand to the reference ``[chan][beam][ant][4]`` f32 layout."""
        stacked = np.stack(
            [self.delay_s, self.delay_rate_sps, self.phase_rad, self.phase_rate_radps],
            axis=-1,
        ).astype(np.float32)
        return np.broadcast_to(
            stacked, (n_channels_per_stream,) + stacked.shape
        ).copy()

    def at_time(self, t_s: float) -> "DelayModel":
        """Evaluate the polynomial at ``t_s`` seconds past the reference epoch.

        Mirrors ``fDeltaDelay = rate·Δt`` / ``fDeltaPhase = phase_rate·Δt``
        extrapolation in the native grouped-timestamps kernel
        (BeamformerKernels.cu:156-166).
        """
        return DelayModel(
            (self.delay_s + self.delay_rate_sps * t_s).astype(np.float32),
            self.delay_rate_sps,
            (self.phase_rad + self.phase_rate_radps * t_s).astype(np.float32),
            self.phase_rate_radps,
        )


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m`` (tile alignment helper)."""
    return cdiv(x, m) * m


def log2_int(x: int) -> int:
    v = int(math.log2(x))
    if 1 << v != x:
        raise ValueError(f"{x} is not a power of two")
    return v
