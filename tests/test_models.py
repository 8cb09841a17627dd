"""Engine-model tests: the reference's fused op-sequence test pattern.

``test_bengine_matches_golden_chain`` is the JAX analog of
``beamform_op_sequence_test.py:37-200`` (random input through the fused
chain vs the CPU golden chain at rtol=atol=1e-4); the F-engine and fused
F+B tests add the physics checks the reference's BDD channelisation spec
demands (peak centred, coherent gain).
"""

import numpy as np
import pytest

import tests.parameters as parameters
from dpdk_dc_sand_tpu import golden
from dpdk_dc_sand_tpu.config import ArrayConfig
from dpdk_dc_sand_tpu.models import BeamformPipeline, FBEngine, FEngine

RNG = np.random.default_rng(seed=2021)


@pytest.mark.combinations(
    "n_ants, n_channels, n_beams, n_batches",
    parameters.array_size,
    parameters.num_channels,
    parameters.num_beams,
    parameters.num_batches,
)
def test_bengine_matches_golden_chain(n_ants, n_channels, n_beams, n_batches):
    cfg = ArrayConfig(
        n_ants=n_ants, n_channels=n_channels, n_beams=n_beams, n_batches=n_batches
    )
    pipe = BeamformPipeline(cfg, xeng_id=1)
    samples, dv = pipe.example_inputs()
    got = np.asarray(pipe(samples, dv))

    reordered = golden.reorder(samples)
    coeffs = golden.steering_coeffs_matrix(
        dv, cfg.n_batches, cfg.n_pols, cfg.n_channels, cfg.sample_period, 1
    )
    want = golden.beamform(reordered, coeffs)
    assert got.shape == cfg.beam_shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


class TestFEngine:
    cfg = ArrayConfig(n_ants=3, n_channels=128, n_taps=8)

    def test_matches_golden_chain(self):
        fe = FEngine(self.cfg, n_spectra=8)
        adc, cd, fd, ph = fe.example_inputs()
        got = np.asarray(fe(adc, cd, fd, ph))
        assert got.shape == (3, 2, 8, 128, 2)

        window = np.asarray(golden.pfb_window(self.cfg.n_taps, self.cfg.fft_size))
        out_len = (8 + self.cfg.n_taps - 1) * self.cfg.fft_size
        for a in range(3):
            stream = golden.coarse_delay(adc[a], int(cd[a]))[..., :out_len]
            spectra = golden.pfb_channelise(
                stream.astype(np.float32), window
            )  # [P, S, C]
            corrected = golden.apply_fine_delay(
                spectra, fd[a], ph[a], self.cfg.n_channels
            )
            want = golden.requantise(corrected, 1.0 / 16.0)
            # Device f32 vs host f64 rounding: allow 1 LSB at bin edges.
            diff = np.abs(
                got[a].astype(np.int32) - want.astype(np.int32)
            )
            assert diff.max() <= 1
            assert (diff > 0).mean() < 0.02

    def test_tone_lands_in_channel(self):
        fe = FEngine(self.cfg, n_spectra=8, quant_scale=1.0)
        k = 37
        n = np.arange(fe.samples_in + 64)
        tone = 100 * np.cos(2 * np.pi * k * n / self.cfg.fft_size)
        adc = np.broadcast_to(
            tone.astype(np.int8), (3, 2, n.size)
        ).copy()
        zeros = np.zeros(3, np.float32)
        out = np.asarray(fe(adc, np.zeros(3, np.int32), zeros, zeros))
        power = (out[..., 0].astype(np.float64) ** 2 + out[..., 1] ** 2).astype(
            np.float64
        )
        # [A, P, S, C] — peak channel per spectrum
        assert (np.argmax(power, axis=-1) == k).all()


class TestFBEngine:
    cfg = ArrayConfig(n_ants=4, n_channels=128, n_beams=2, n_taps=8)

    def test_matches_fengine_plus_golden_beamform(self):
        fb = FBEngine(self.cfg, n_spectra=8)
        adc, cd, fd, ph, dv = fb.example_inputs()
        got = np.asarray(fb(adc, cd, fd, ph, dv))
        assert got.shape == (2, 128, 8, 2, 2)

        fe = FEngine(self.cfg, n_spectra=8)
        quant = np.asarray(fe(adc, cd, fd, ph))  # [A, P, S, C, 2]
        x = quant[..., 0].astype(np.float64) + 1j * quant[..., 1]
        x = x.transpose(1, 3, 2, 0)  # [P, C, S, A]
        dv_full = np.broadcast_to(
            dv, (self.cfg.n_channels,) + dv.shape
        )
        w = golden.steering_coeffs_complex(
            dv_full, self.cfg.n_channels, self.cfg.sample_period
        )
        want = golden.beamform_complex(x, w)  # [P, C, S, beam]
        np.testing.assert_allclose(got[..., 0], want.real, rtol=1e-4, atol=2e-2)
        np.testing.assert_allclose(got[..., 1], want.imag, rtol=1e-4, atol=2e-2)

    def test_beam_requant_output(self):
        """8-bit beam transport format: int8 beams = requantised f32 beams."""
        from dpdk_dc_sand_tpu.golden import requantise as golden_requant

        fb32 = FBEngine(self.cfg, n_spectra=8)
        fb8 = FBEngine(
            self.cfg, n_spectra=8, beam_quant_scale=1 / 8
        )
        adc, cd, fd, ph, dv = fb32.example_inputs()
        beams = np.asarray(fb32(adc, cd, fd, ph, dv))
        got = np.asarray(fb8(adc, cd, fd, ph, dv))
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, golden_requant(beams, 1 / 8))

    def test_coherent_gain_on_aligned_tone(self):
        """Steered beam on an aligned array shows n_ants² power gain."""
        cfg = self.cfg
        fb = FBEngine(cfg, n_spectra=8, quant_scale=1.0)
        k = 40
        n = np.arange(fb.samples_in + 8)
        tone = (80 * np.cos(2 * np.pi * k * n / cfg.fft_size)).astype(np.int8)
        adc = np.broadcast_to(tone, (cfg.n_ants, cfg.n_pols, n.size)).copy()
        zeros_i = np.zeros(cfg.n_ants, np.int32)
        zeros_f = np.zeros(cfg.n_ants, np.float32)
        dv = np.zeros((cfg.n_beams, cfg.n_ants, 4), np.float32)
        # beam 0 steered (zero phase); beam 1 scrambled
        dv[1, :, 2] = np.linspace(0, np.pi, cfg.n_ants)
        out = np.asarray(fb(adc, zeros_i, zeros_f, zeros_f, dv))
        power = out[..., 0].astype(np.float64) ** 2 + out[..., 1] ** 2
        p0 = power[0, k, 4, 0]
        p1 = power[0, k, 4, 1]
        # identical antennas, unit weights -> sum of n_ants equal vectors
        single = p0 / cfg.n_ants**2
        assert p0 > 0
        assert p1 < 0.5 * p0
        # cross-check coherent gain against one antenna's channelised power
        fe = FEngine(cfg, n_spectra=8, quant_scale=1.0)
        q = np.asarray(fe(adc, zeros_i, zeros_f, zeros_f))
        p_single = float(q[0, 0, 4, k, 0]) ** 2 + float(q[0, 0, 4, k, 1]) ** 2
        assert p0 == pytest.approx(cfg.n_ants**2 * p_single, rel=1e-3)


class TestFXBEngine:
    def test_beams_and_visibilities_consistent(self):
        """FXB ≡ FBEngine beams + XEngine-style correlation of the same
        F-stage output."""
        from dpdk_dc_sand_tpu.models import FXBEngine

        cfg = ArrayConfig(n_ants=3, n_channels=128, n_beams=2, n_taps=4)
        fxb = FXBEngine(cfg, n_spectra=8)
        adc, cd, fd, ph, dv = fxb.example_inputs()
        beams, vre, vim = fxb(adc, cd, fd, ph, dv)
        beams = np.asarray(beams)
        assert beams.shape == (2, 128, 8, 2, 2)
        assert np.asarray(vre).shape == (128, 6, 6)

        # beams match the FB engine on identical inputs
        fb = FBEngine(cfg, n_spectra=8)
        want_beams = np.asarray(fb(adc, cd, fd, ph, dv))
        np.testing.assert_allclose(beams, want_beams, rtol=1e-5, atol=1e-3)

        # visibilities match golden correlation of the F-stage output
        fe = FEngine(cfg, n_spectra=8)
        quant = np.asarray(fe(adc, cd, fd, ph))  # [A, P, S, C, 2]
        x = quant.transpose(3, 2, 0, 1, 4).reshape(128, 8, 6, 2)
        want_re, want_im = golden.correlate_planar(x[..., 0], x[..., 1])
        np.testing.assert_allclose(np.asarray(vre), want_re, rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(np.asarray(vim), want_im, rtol=1e-4, atol=1e-2)


class TestVisibilityAccumulator:
    def test_dump_cadence_and_sum(self):
        """n_accum steps integrate into one dump equal to the per-step sum;
        the window then restarts cleanly."""
        from dpdk_dc_sand_tpu.models import VisibilityAccumulator
        from dpdk_dc_sand_tpu.ops.correlate import correlate

        rng = np.random.default_rng(2021)
        blocks = rng.integers(-64, 64, size=(7, 16, 4, 6, 2), dtype=np.int8)
        acc = VisibilityAccumulator(n_accum=3)
        dumps = []
        for seq, block in enumerate(blocks):
            out = acc.add_samples(block, seq=seq)
            if out is not None:
                dumps.append(out)
        assert len(dumps) == 2
        assert acc.count == 1  # 7th step started window 3
        assert [d[2] for d in dumps] == [0, 3]
        for w, (vre, vim, _) in enumerate(dumps):
            want_re = np.zeros((16, 6, 6), np.float32)
            want_im = np.zeros_like(want_re)
            for block in blocks[3 * w : 3 * w + 3]:
                r, i = correlate(block)
                want_re += np.asarray(r)
                want_im += np.asarray(i)
            np.testing.assert_allclose(np.asarray(vre), want_re, rtol=1e-6)
            np.testing.assert_allclose(np.asarray(vim), want_im, rtol=1e-6)

    def test_precorrelated_path_matches(self):
        """Feeding (V_re, V_im) pairs gives the same dump as raw samples."""
        from dpdk_dc_sand_tpu.models import VisibilityAccumulator
        from dpdk_dc_sand_tpu.ops.correlate import correlate

        rng = np.random.default_rng(7)
        blocks = rng.integers(-64, 64, size=(4, 8, 4, 6, 2), dtype=np.int8)
        a = VisibilityAccumulator(n_accum=4)
        b = VisibilityAccumulator(n_accum=4)
        for seq, block in enumerate(blocks):
            da = a.add_samples(block, seq=seq)
            db = b.add(*correlate(block), seq=seq)
        assert da is not None and db is not None
        np.testing.assert_allclose(np.asarray(da[0]), np.asarray(db[0]), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(da[1]), np.asarray(db[1]), rtol=1e-6)
        assert da[2] == db[2] == 0

    def test_integrates_fxb_visibilities(self):
        """The FXB per-step visibilities stream straight into the
        accumulator (the instrument's full X path)."""
        from dpdk_dc_sand_tpu.models import FXBEngine, VisibilityAccumulator

        cfg = ArrayConfig(n_ants=3, n_channels=128, n_beams=2, n_taps=4)
        fxb = FXBEngine(cfg, n_spectra=8)
        adc, cd, fd, ph, dv = fxb.example_inputs()
        acc = VisibilityAccumulator(n_accum=2)
        _, vre, vim = fxb(adc, cd, fd, ph, dv)
        assert acc.add(vre, vim, seq=10) is None
        _, vre2, vim2 = fxb(adc, cd, fd, ph, dv)
        dump = acc.add(vre2, vim2, seq=11)
        assert dump is not None
        vre_w, vim_w, first = dump
        assert first == 10
        np.testing.assert_allclose(
            np.asarray(vre_w), 2 * np.asarray(vre), rtol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(vim_w), 2 * np.asarray(vim), rtol=1e-6
        )


def test_fbengine_folded_bstage_matches_planar():
    """bstage="folded" single-dot beamform == planar 4-dot beamform.

    Same arithmetic (block-concat weights vs planar cos/sin), f32 MACs
    both sides, so beams agree to float tolerance.
    """
    cfg = ArrayConfig(n_ants=5, n_channels=64, n_beams=3, n_taps=4)
    planar = FBEngine(cfg, n_spectra=8, precision="f32")
    folded = FBEngine(cfg, n_spectra=8, precision="f32", bstage="folded")
    inputs = planar.example_inputs()
    want = np.asarray(planar(*inputs))
    got = np.asarray(folded(*inputs))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_steering_cache_tracks_values_not_identity():
    """A fresh delay solution must regenerate the steering planes even
    when CPython hands the new array the dead previous array's address.

    Regression for the ``id()``-keyed coefficient cache: EngineNode
    passes a fresh ``delay_vals.copy()`` each chunk and drops the
    previous copy, so object-address reuse could silently serve stale
    steering for a whole 256-chunk reuse cadence (coefficients must
    track CAM updates, BeamformerParameters.h:53-66). The cache now keys
    on a content digest (ops.coeff_gen.steering_key).
    """
    cfg = ArrayConfig(n_ants=3, n_channels=128, n_beams=2, n_taps=4)
    eng = FBEngine(cfg, n_spectra=4)

    dv = np.zeros((cfg.n_beams, cfg.n_ants, 4), np.float32)
    eng.set_beam_delays(dv)
    import jax

    before = [np.asarray(x) for x in jax.tree_util.tree_leaves(eng._coeff_blocks)]
    dead_id = id(dv)
    del dv

    # Force address reuse: allocate/free identically-shaped arrays until
    # one lands on the dead object's address (usually the first try).
    reused = False
    for _ in range(1000):
        dv2 = np.zeros((cfg.n_beams, cfg.n_ants, 4), np.float32)
        dv2[:, :, 2] = 1.0  # a genuinely different solution: phase = 1 rad
        if id(dv2) == dead_id:
            reused = True
            break
        del dv2
    if not reused:  # pragma: no cover - allocator-dependent
        dv2 = np.zeros((cfg.n_beams, cfg.n_ants, 4), np.float32)
        dv2[:, :, 2] = 1.0

    eng.set_beam_delays(dv2)
    after = [np.asarray(x) for x in jax.tree_util.tree_leaves(eng._coeff_blocks)]
    assert any(
        not np.array_equal(b, a) for b, a in zip(before, after)
    ), "steering planes did not track the new delay solution"


def test_steering_key_is_content_keyed():
    from dpdk_dc_sand_tpu.ops.coeff_gen import steering_key

    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    b = a.copy()
    assert steering_key(a, None, 0.0) == steering_key(b, None, 0.0)
    b[0, 0, 0] += 1.0
    assert steering_key(a, None, 0.0) != steering_key(b, None, 0.0)
    w = np.ones(3, np.float32)
    assert steering_key(a, None, 0.0) != steering_key(a, w, 0.0)
    w2 = w.copy()
    w2[1] = 0.5
    assert steering_key(a, w, 0.0) != steering_key(a, w2, 0.0)
    assert steering_key(a, w, 0.0) != steering_key(a, w, 1.0)
