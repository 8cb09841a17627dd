"""Tests for the CPU golden models (the oracles everything else trusts).

These validate the golden models against first principles: direct loop
implementations, analytic signals, and complex-vs-real-layout consistency —
so that downstream device-op parity tests inherit a trustworthy reference.
"""

import numpy as np
import pytest

from dpdk_dc_sand_tpu import golden
from dpdk_dc_sand_tpu.config import ArrayConfig

RNG = np.random.default_rng(seed=2021)


# ----------------------------------------------------------------------
# Corner-turn reorder
# ----------------------------------------------------------------------
class TestReorder:
    def test_against_direct_indexing(self):
        b, a, c, t, p, x = 2, 3, 4, 32, 2, 2
        samples = RNG.integers(0, 255, size=(b, a, c, t, p, x), dtype=np.uint8)
        out = golden.reorder(samples)
        for bi in range(b):
            for ai in range(a):
                for ci in range(c):
                    for ti in range(t):
                        for pi in range(p):
                            for xi in range(x):
                                assert (
                                    out[bi, pi, ci, ti // 16, ti % 16, ai, xi]
                                    == samples[bi, ai, ci, ti, pi, xi]
                                )

    def test_roundtrip(self):
        samples = RNG.integers(0, 255, size=(1, 5, 7, 64, 2, 2), dtype=np.uint8)
        assert np.array_equal(
            golden.reorder_inverse(golden.reorder(samples)), samples
        )

    def test_bad_time_axis(self):
        with pytest.raises(ValueError):
            golden.reorder(np.zeros((1, 1, 1, 17, 2, 2), np.uint8))


# ----------------------------------------------------------------------
# Steering coefficients
# ----------------------------------------------------------------------
class TestCoeffs:
    cfg = ArrayConfig(n_ants=4, n_channels=256, n_beams=4)

    def _delay_vals(self, delay_s=0.0, phase=0.0):
        dv = np.zeros(self.cfg.delay_vals_shape, np.float32)
        dv[..., 0] = delay_s
        dv[..., 2] = phase
        return dv

    def test_zero_delay_gives_pure_phase(self):
        dv = self._delay_vals(phase=0.7)
        w = golden.steering_coeffs_complex(
            dv, self.cfg.n_channels, self.cfg.sample_period
        )
        assert w.shape == (self.cfg.n_channels_per_stream, 4, 4)
        np.testing.assert_allclose(np.angle(w), 0.7, rtol=1e-6)
        np.testing.assert_allclose(np.abs(w), 1.0, rtol=1e-6)

    def test_rotation_formula_elementwise(self):
        """Check against the reference formula written out verbatim."""
        delay, phase = 3.2e-9, 0.5
        xeng_id = 2
        dv = self._delay_vals(delay, phase)
        w = golden.steering_coeffs_complex(
            dv, self.cfg.n_channels, self.cfg.sample_period, xeng_id=xeng_id
        )
        n = self.cfg.n_channels
        ts = self.cfg.sample_period
        for ci in range(self.cfg.n_channels_per_stream):
            ichannel = ci + self.cfg.n_channels_per_stream * xeng_id
            initial_phase = delay * ichannel * (-np.pi) / (n * ts) + phase
            correction = delay * (n / 2) * (-np.pi) / (n * ts)
            rot = initial_phase - correction
            np.testing.assert_allclose(
                w[ci, 0, 0], np.cos(rot) + 1j * np.sin(rot), rtol=1e-5
            )

    def test_matrix_block_structure(self):
        """2x2 blocks are [[c, s], [-s, c]] (coeff_generator.py:91-103)."""
        dv = self._delay_vals(1e-9, 0.3)
        w = golden.steering_coeffs_complex(
            dv, self.cfg.n_channels, self.cfg.sample_period
        )
        m = golden.complex_to_matrix(w)
        assert m.shape == (self.cfg.n_channels_per_stream, 8, 8)
        c, s = w[5, 2, 3].real, w[5, 2, 3].imag
        blk = m[5, 2 * 3 : 2 * 3 + 2, 2 * 2 : 2 * 2 + 2]
        np.testing.assert_allclose(blk, [[c, s], [-s, c]], rtol=1e-6)

    def test_matrix_multiplication_is_complex_multiplication(self):
        dv = self._delay_vals(2e-9, -0.4)
        w = golden.steering_coeffs_complex(
            dv, self.cfg.n_channels, self.cfg.sample_period
        )
        m = golden.complex_to_matrix(w)
        x = (RNG.normal(size=4) + 1j * RNG.normal(size=4)).astype(np.complex64)
        xr = np.empty(8, np.float32)
        xr[0::2], xr[1::2] = x.real, x.imag
        yr = xr @ m[0]
        y = golden.beamform_complex(x[None, None, :], w[:1])[0, 0]
        np.testing.assert_allclose(yr[0::2], y.real, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(yr[1::2], y.imag, rtol=1e-5, atol=1e-5)

    def test_time_extrapolation(self):
        dv = self._delay_vals(1e-9, 0.1)
        dv[..., 1] = 1e-12  # delay rate
        dv[..., 3] = 0.05  # phase rate
        t = 2.0
        w_t = golden.steering_coeffs_complex(
            dv, self.cfg.n_channels, self.cfg.sample_period, t_s=t
        )
        dv2 = self._delay_vals(1e-9 + 1e-12 * t, 0.1 + 0.05 * t)
        w_expect = golden.steering_coeffs_complex(
            dv2, self.cfg.n_channels, self.cfg.sample_period
        )
        np.testing.assert_allclose(w_t, w_expect, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# Beamforming
# ----------------------------------------------------------------------
class TestBeamform:
    def test_real_layout_matches_complex(self):
        cfg = ArrayConfig(n_ants=5, n_channels=256, n_beams=3, n_batches=2)
        cps = cfg.n_channels_per_stream
        samples = RNG.integers(
            -100, 100, size=cfg.ingest_shape, dtype=np.int8
        ).astype(np.int8)
        reordered = golden.reorder(samples)
        dv = RNG.normal(size=(cps, 3, 5, 4)).astype(np.float32) * np.array(
            [1e-9, 0, 1, 0], np.float32
        )
        w = golden.steering_coeffs_complex(dv, cfg.n_channels, cfg.sample_period)
        m = golden.complex_to_matrix(w)
        coeffs = np.broadcast_to(
            m, (cfg.n_batches, cfg.n_pols) + m.shape
        ).copy()

        out = golden.beamform(reordered, coeffs)
        assert out.shape == (2, 2, cps, 16, 16, 6)

        # complex-domain check
        cplx = (
            samples[..., 0].astype(np.float32)
            + 1j * samples[..., 1].astype(np.float32)
        )  # [b, a, c, t, p]
        cplx = cplx.transpose(0, 4, 2, 3, 1)  # [b, p, c, t, a]
        ref = golden.beamform_complex(cplx, w)  # [b, p, c, t, beam]
        got = out.reshape(2, 2, cps, 256, 6)
        np.testing.assert_allclose(
            got[..., 0::2], ref.real, rtol=1e-4, atol=1e-2
        )
        np.testing.assert_allclose(
            got[..., 1::2], ref.imag, rtol=1e-4, atol=1e-2
        )

    def test_single_antenna_unit_weight_passthrough(self):
        x = (RNG.normal(size=(1, 4, 8)) + 1j * RNG.normal(size=(1, 4, 8))).astype(
            np.complex64
        )  # [chan=1? no: [..., chan, time, ant]]
        w = np.ones((1, 1, 8), np.complex64) / 8
        out = golden.beamform_complex(x[:1], w[:1])
        np.testing.assert_allclose(
            out[..., 0], x.mean(axis=-1), rtol=1e-5, atol=1e-6
        )


# ----------------------------------------------------------------------
# PFB channeliser
# ----------------------------------------------------------------------
class TestPfb:
    n_taps, n_channels = 16, 128

    def _tone(self, channel, n_spectra, amp=100.0, phase=0.0):
        cfg_fft = 2 * self.n_channels
        n = np.arange((n_spectra + self.n_taps - 1) * cfg_fft)
        return amp * np.cos(2 * np.pi * channel * n / cfg_fft + phase)

    def test_tone_peaks_in_channel_centre(self):
        window = golden.pfb_window(self.n_taps, 2 * self.n_channels)
        for k in (3, 40, 100):
            spectra = golden.pfb_channelise(self._tone(k, 8), window)
            assert spectra.shape == (8, self.n_channels)
            power = np.abs(spectra[4]) ** 2
            assert int(np.argmax(power)) == k

    def test_leakage_below_minus_62db(self):
        """Channelisation acceptance spec (channelisation.feature:5-9)."""
        window = golden.pfb_window(self.n_taps, 2 * self.n_channels)
        k = 37
        spectra = golden.pfb_channelise(self._tone(k, 8), window)
        power = np.abs(spectra[4]) ** 2
        rel_db = 10 * np.log10(power / power[k] + 1e-300)
        mask = np.ones(self.n_channels, bool)
        mask[k] = False
        assert rel_db[mask].max() <= -62.0, rel_db[mask].max()

    def test_linearity(self):
        window = golden.pfb_window(self.n_taps, 2 * self.n_channels)
        x = RNG.normal(size=(2, (4 + self.n_taps - 1) * 2 * self.n_channels))
        a = golden.pfb_channelise(x[0], window)
        b = golden.pfb_channelise(x[1], window)
        ab = golden.pfb_channelise(x[0] + x[1], window)
        np.testing.assert_allclose(ab, a + b, rtol=1e-3, atol=1e-3)

    def test_fir_frame_count(self):
        window = golden.pfb_window(4, 64)
        x = np.zeros(10 * 64)
        assert golden.pfb_fir(x, window).shape == (7, 64)


# ----------------------------------------------------------------------
# Delay correction
# ----------------------------------------------------------------------
class TestDelay:
    def test_coarse_delay_shifts(self):
        x = np.arange(100.0)
        np.testing.assert_array_equal(golden.coarse_delay(x, 7), x[7:])

    def test_fine_delay_matches_time_shift(self):
        """Half-sample fine delay ≈ FFT of half-sample-shifted signal."""
        n_taps, n_channels = 16, 128
        fft_size = 2 * n_channels
        window = golden.pfb_window(n_taps, fft_size)
        k = 32  # tone at channel-centre k
        n = np.arange((8 + n_taps - 1) * fft_size)
        d = 0.5
        x0 = np.cos(2 * np.pi * k * n / fft_size)
        x_shift = np.cos(2 * np.pi * k * (n + d) / fft_size)
        s0 = golden.pfb_channelise(x0, window)
        s_shift = golden.pfb_channelise(x_shift, window)
        # Correct the shifted stream by fine delay d: phase at bin k should
        # realign with the unshifted stream up to the band-centre reference
        # convention. Compare phase *differences* at the tone bin.
        corrected = golden.apply_fine_delay(
            s_shift, np.array(d), np.array(0.0), n_channels
        )
        ang_err = np.angle(corrected[4, k] / s0[4, k])
        # The convention references band centre (k - n/2); compensate.
        expected = 2 * np.pi * k * d / fft_size - np.pi * d * (
            k - n_channels / 2
        ) / n_channels
        assert abs(((ang_err - expected + np.pi) % (2 * np.pi)) - np.pi) < 2e-2

    def test_apply_fine_delay_zero_is_identity(self):
        s = (RNG.normal(size=(3, 4, 16)) + 1j * RNG.normal(size=(3, 4, 16))).astype(
            np.complex64
        )
        out = golden.apply_fine_delay(s, np.zeros(3), np.zeros(3), 16)
        np.testing.assert_allclose(out, s, rtol=1e-6)


# ----------------------------------------------------------------------
# Requantisation
# ----------------------------------------------------------------------
class TestRequant:
    def test_rounds_and_clips(self):
        x = np.array([0.4, 0.6, -200.0, 200.0, 126.49])
        out = golden.requantise(x, 1.0)
        np.testing.assert_array_equal(out, [0, 1, -127, 127, 126])
        assert out.dtype == np.int8

    def test_complex_interleave(self):
        x = np.array([1.0 + 2.0j, -3.0 - 4.0j])
        out = golden.requantise(x, 10.0)
        np.testing.assert_array_equal(out, [[10, 20], [-30, -40]])
