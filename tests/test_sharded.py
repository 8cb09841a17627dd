"""Distributed-pipeline tests on the virtual 8-device CPU mesh.

The reference tests its multi-node layer with in-process fakes
(test_corr3_servlet.py:14-50); here the analog is the forced-8-device CPU
platform: the full sharded step (ppermute halo + all_to_all corner turn +
antenna psum) runs on a real multi-device mesh and is checked against the
single-device fused pipeline.
"""

import jax
import numpy as np
import pytest

from dpdk_dc_sand_tpu.config import ArrayConfig
from dpdk_dc_sand_tpu.models import FBEngine
from dpdk_dc_sand_tpu.parallel import ShardedFBEngine, factor_devices, make_mesh


def test_factor_devices():
    assert factor_devices(8) == (2, 4)
    assert factor_devices(6) == (2, 3)
    assert factor_devices(7) == (1, 7)
    assert factor_devices(1) == (1, 1)


def test_mesh_shape():
    mesh = make_mesh(8)
    assert mesh.shape == {"ant": 2, "time": 4}
    assert len(mesh.devices.ravel()) == 8


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 8), (8, 1), (2, 2)])
def test_sharded_matches_single_device(shape):
    """Sharded step ≡ fused single-chip step (circular-halo convention)."""
    n_dev = shape[0] * shape[1]
    mesh = make_mesh(n_dev, shape=shape)
    cfg = ArrayConfig(n_ants=8, n_channels=128, n_beams=4, n_taps=4)
    n_spectra = 4 * shape[1]  # ≥ n_taps − 1 spectra per time shard
    eng = ShardedFBEngine(cfg, mesh, n_spectra=n_spectra)
    adc, fd, ph, dv = eng.example_inputs()
    got = np.asarray(eng(adc, fd, ph, dv))
    assert got.shape == (2, 128, n_spectra, 4, 2)

    # Single-device reference: same circular halo = prepend global tail.
    halo = (cfg.n_taps - 1) * cfg.fft_size
    adc_ext = np.concatenate([adc[..., -halo:], adc], axis=-1)
    fb = FBEngine(cfg, n_spectra=n_spectra)
    want = np.asarray(
        fb(adc_ext, np.zeros(cfg.n_ants, np.int32), fd, ph, dv)
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (1, 8)])
def test_sharded_fplanes_within_one_code_of_single_chip(shape):
    """Distributed F planes ≡ single-chip F planes to ±1 int8 code.

    The elementwise bound on the *quantised planes* (the
    golden.chain.check_codes discipline): any sharding-induced float difference
    may flip a round-half-even tie by at most one code, and must do so
    rarely.
    """
    n_dev = shape[0] * shape[1]
    mesh = make_mesh(n_dev, shape=shape)
    cfg = ArrayConfig(n_ants=8, n_channels=128, n_beams=4, n_taps=4)
    n_spectra = 4 * shape[1]
    eng = ShardedFBEngine(cfg, mesh, n_spectra=n_spectra, emit_planes=True)
    adc, fd, ph, _ = eng.example_inputs()
    qr, qi = eng(adc, fd, ph, np.zeros((4, 8, 4), np.float32))
    got = np.stack([np.asarray(qr), np.asarray(qi)], axis=-1).astype(np.int32)

    from dpdk_dc_sand_tpu.models import FEngine

    halo = (cfg.n_taps - 1) * cfg.fft_size
    adc_ext = np.concatenate([adc[..., -halo:], adc], axis=-1)
    fe = FEngine(cfg, n_spectra=n_spectra)
    want = np.asarray(
        fe(adc_ext, np.zeros(cfg.n_ants, np.int32), fd, ph)
    ).astype(np.int32)
    diff = np.abs(got - want)
    assert diff.max() <= 1
    assert (diff != 0).mean() <= 1e-3


def test_sharded_rejects_bad_factorisation():
    mesh = make_mesh(8, shape=(2, 4))
    with pytest.raises(ValueError):
        ShardedFBEngine(
            ArrayConfig(n_ants=7, n_channels=128), mesh, n_spectra=16
        )
    with pytest.raises(ValueError):
        # time shards thinner than the FIR halo
        ShardedFBEngine(
            ArrayConfig(n_ants=8, n_channels=128, n_taps=16), mesh, n_spectra=16
        )


def test_output_sharding_is_channel_sharded():
    mesh = make_mesh(8, shape=(2, 4))
    cfg = ArrayConfig(n_ants=8, n_channels=128, n_beams=4, n_taps=4)
    eng = ShardedFBEngine(cfg, mesh, n_spectra=16)
    out = eng(*eng.example_inputs())
    # channel axis (1) split over "time" (4 shards)
    shard_shapes = {s.data.shape for s in out.addressable_shards}
    assert shard_shapes == {(2, 128 // 4, 16, 4, 2)}


# ----------------------------------------------------------------------
# Distributed ingest (per-host shard assembly)
# ----------------------------------------------------------------------
def test_ingest_assembles_sharded_array():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dpdk_dc_sand_tpu.parallel import scatter_local, shard_indices

    mesh = make_mesh(8, shape=(2, 4))
    sharding = NamedSharding(mesh, P("ant", None, "time"))
    data = np.arange(8 * 2 * 16, dtype=np.int8).reshape(8, 2, 16)
    idx = shard_indices(sharding, data.shape)
    assert len(idx) == 8
    arr = scatter_local(data, sharding)
    assert arr.shape == data.shape
    assert arr.sharding == sharding
    np.testing.assert_array_equal(np.asarray(arr), data)
    # each device holds only its slice
    shard_shapes = {s.data.shape for s in arr.addressable_shards}
    assert shard_shapes == {(4, 2, 4)}


def test_ingest_feeds_sharded_engine():
    """Per-shard provider -> global array -> distributed step (the
    production feed path, single-host edition)."""
    from dpdk_dc_sand_tpu.parallel import assemble_global

    mesh = make_mesh(8, shape=(2, 4))
    cfg = ArrayConfig(n_ants=8, n_channels=128, n_beams=4, n_taps=4)
    eng = ShardedFBEngine(cfg, mesh, n_spectra=16)
    adc, fd, ph, dv = eng.example_inputs()

    calls = []

    def provider(idx):
        calls.append(idx)
        return adc[idx]

    global_adc = assemble_global(provider, eng.sample_sharding, adc.shape)
    assert len(calls) == 8
    out = eng(global_adc, fd, ph, dv)
    want = np.asarray(eng(adc, fd, ph, dv))
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5, atol=1e-3)


def test_sharded_visibilities_match_golden():
    """emit_visibilities: all_gather over the ant axis + local correlation
    equals golden correlation of the single-device F-stage output."""
    from dpdk_dc_sand_tpu import golden
    from dpdk_dc_sand_tpu.models import FEngine

    mesh = make_mesh(8, shape=(2, 4))
    cfg = ArrayConfig(n_ants=8, n_channels=128, n_beams=4, n_taps=4)
    eng = ShardedFBEngine(cfg, mesh, n_spectra=16, emit_visibilities=True)
    adc, fd, ph, dv = eng.example_inputs()
    beams, vre, vim = eng(adc, fd, ph, dv)
    assert np.asarray(vre).shape == (128, 16, 16)

    # single-device reference: same circular-halo F stage, then correlate
    halo = (cfg.n_taps - 1) * cfg.fft_size
    adc_ext = np.concatenate([adc[..., -halo:], adc], axis=-1)
    fe = FEngine(cfg, n_spectra=16)
    quant = np.asarray(
        fe(adc_ext, np.zeros(cfg.n_ants, np.int32), fd, ph)
    )  # [A, P, S, C, 2]
    # engine x-layout: [C, S, A·P, 2] with (ant-major, pol-minor) inputs
    x = quant.transpose(3, 2, 0, 1, 4).reshape(128, 16, 16, 2)
    # Visibilities are sums of int8-code products (exact in f32 at these
    # shapes), so planes matching ⇒ near-exact agreement; the small atol
    # covers f32 summation-order differences only.
    want_re, want_im = golden.correlate_planar(x[..., 0], x[..., 1])
    np.testing.assert_allclose(np.asarray(vre), want_re, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(vim), want_im, rtol=1e-4, atol=1e-3)
    # channel-sharded over the time axis
    assert {s.data.shape for s in vre.addressable_shards} == {(32, 16, 16)}


def test_scatter_beams_matches_psum():
    """reduce-scatter beam reduction ≡ all-reduce, with beam-sharded output."""
    mesh = make_mesh(8, shape=(2, 4))
    cfg = ArrayConfig(n_ants=8, n_channels=128, n_beams=4, n_taps=4)
    eng = ShardedFBEngine(cfg, mesh, n_spectra=16)
    eng_rs = ShardedFBEngine(cfg, mesh, n_spectra=16, scatter_beams=True)
    inputs = eng.example_inputs()
    want = np.asarray(eng(*inputs))
    got = eng_rs(*inputs)
    # beams (axis 3) additionally split over "ant" (2 shards)
    shard_shapes = {s.data.shape for s in got.addressable_shards}
    assert shard_shapes == {(2, 128 // 4, 16, 4 // 2, 2)}
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-4)


def test_scatter_beams_rejects_indivisible():
    mesh = make_mesh(8, shape=(2, 4))
    with pytest.raises(ValueError, match="scatter_beams"):
        ShardedFBEngine(
            ArrayConfig(n_ants=8, n_channels=128, n_beams=3, n_taps=4),
            mesh,
            n_spectra=16,
            scatter_beams=True,
        )


def test_sharded_steering_extrapolation_and_weights():
    """Distributed steering parity with the single-chip engine.

    Nonzero delay/phase rates at t_s > 0 must rotate the sharded beams
    exactly as the (golden-tested) single-chip path does — the
    grouped-timestamps extrapolation contract (BeamformerKernels.cu:
    121-189) — and ?beam-weights must fold in per-antenna magnitudes
    (corr3_servlet.py:140-153).
    """
    mesh = make_mesh(4, shape=(2, 2))
    cfg = ArrayConfig(n_ants=8, n_channels=128, n_beams=4, n_taps=4)
    n_spectra = 8
    eng = ShardedFBEngine(cfg, mesh, n_spectra=n_spectra)
    adc, fd, ph, dv = eng.example_inputs()
    rng = np.random.default_rng(7)
    dv = dv.copy()
    dv[..., 1] = rng.uniform(-1e-11, 1e-11, dv.shape[:-1])  # delay rates
    dv[..., 3] = rng.uniform(-0.1, 0.1, dv.shape[:-1])  # phase rates
    weights = rng.uniform(0.5, 1.5, cfg.n_ants).astype(np.float32)
    t = 1.25

    got0 = np.asarray(eng(adc, fd, ph, dv, ant_weights=weights, t_s=0.0))
    got_t = np.asarray(eng(adc, fd, ph, dv, ant_weights=weights, t_s=t))
    # The rates must measurably rotate the beams over time.
    assert np.max(np.abs(got_t - got0)) > 1e-2

    # Single-device reference at the same instant (same circular halo).
    halo = (cfg.n_taps - 1) * cfg.fft_size
    adc_ext = np.concatenate([adc[..., -halo:], adc], axis=-1)
    fb = FBEngine(cfg, n_spectra=n_spectra)
    fb.set_beam_delays(dv, ant_weights=weights, t_s=t)
    want = np.asarray(
        fb.step(adc_ext, np.zeros(cfg.n_ants, np.int32), fd, ph)
    )
    np.testing.assert_allclose(got_t, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("chunks", [2, 4, "auto"])
def test_ici_interleaved_step_matches_monolithic(chunks):
    """ici_chunks splits the corner turn + beamform + psum into spectra
    sub-blocks whose collectives interleave with the B compute; results
    must equal the monolithic step exactly (same values, same order).
    ``"auto"`` (the shipped default) resolves to the largest of
    {8, 4, 2} that divides the per-device spectra count."""
    mesh = make_mesh(8, shape=(2, 4))
    cfg = ArrayConfig(n_ants=8, n_channels=128, n_beams=4, n_taps=4)
    n_spectra = 32
    kwargs = dict(n_spectra=n_spectra)
    mono = ShardedFBEngine(cfg, mesh, ici_chunks=1, **kwargs)
    inter = ShardedFBEngine(cfg, mesh, ici_chunks=chunks, **kwargs)
    if chunks == "auto":
        # per-device spectra = 32/4 = 8 -> k=8
        assert inter.ici_chunks == 8
    adc, fd, ph, dv = mono.example_inputs()
    want = np.asarray(mono(adc, fd, ph, dv))
    got = np.asarray(inter(adc, fd, ph, dv))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_ici_chunks_auto_resolution():
    """The shipped default: interleave ON (largest dividing k of
    {8,4,2}) on multi-device
    meshes, OFF on single-device meshes and in the emit modes."""
    cfg = ArrayConfig(n_ants=8, n_channels=128, n_beams=4, n_taps=4)
    mesh = make_mesh(8, shape=(2, 4))
    assert ShardedFBEngine(cfg, mesh, n_spectra=32).ici_chunks == 8
    assert ShardedFBEngine(cfg, mesh, n_spectra=12).ici_chunks == 1
    assert (
        ShardedFBEngine(
            cfg, mesh, n_spectra=32, emit_visibilities=True
        ).ici_chunks
        == 1
    )
    solo = make_mesh(1, shape=(1, 1))
    assert ShardedFBEngine(cfg, solo, n_spectra=32).ici_chunks == 1


def test_ici_chunks_validation():
    mesh = make_mesh(8, shape=(2, 4))
    cfg = ArrayConfig(n_ants=8, n_channels=128, n_beams=4, n_taps=4)
    with pytest.raises(ValueError, match="ici_chunks"):
        ShardedFBEngine(cfg, mesh, n_spectra=32, ici_chunks=3)
    with pytest.raises(ValueError, match="ici_chunks"):
        ShardedFBEngine(
            cfg, mesh, n_spectra=32, ici_chunks=2, emit_visibilities=True
        )
