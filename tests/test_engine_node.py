"""EngineNode integration tests: ingest → pipeline → egress + control.

The full vertical on one host: chunks pushed into the node's ring come out
as beams; drop accounting and health surface as sensors over KATCP; delay
updates via control requests change the pipeline output without
recompiling.
"""

import asyncio
import time

import numpy as np
import pytest

from dpdk_dc_sand_tpu.config import ArrayConfig
from dpdk_dc_sand_tpu.control import Client, FailReply
from dpdk_dc_sand_tpu.engine_node import EngineNode

CFG = ArrayConfig(n_ants=4, n_channels=128, n_beams=2, n_taps=4)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def wait_for(cond, timeout=20.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        await asyncio.sleep(interval)
    return False


def make_chunk(seq, node):
    rng = np.random.default_rng(seq)
    return rng.integers(-64, 64, size=node.chunk_shape, dtype=np.int8)


def test_chunks_become_beams_and_sensors_update():
    async def scenario():
        beams_out = []
        node = EngineNode(
            CFG,
            n_spectra=8,
            on_beams=lambda b, seq: beams_out.append((seq, b)),
        )
        await node.start()
        client = await Client("127.0.0.1", node.port).connect()
        try:
            for seq in (0, 1, 3):  # gap at 2
                assert node.submit_chunk(make_chunk(seq, node), seq)
            ok = await wait_for(lambda: len(beams_out) == 3, timeout=60)
            assert ok, f"only {len(beams_out)} beams produced"
            seqs = [s for s, _ in beams_out]
            assert seqs == [0, 1, 3]
            b = beams_out[0][1]
            assert b.shape == (2, 128, 8, 2, 2)
            assert np.isfinite(b).all()
            # sensors over the wire
            _, informs = await client.request("sensor-value", "chunks-processed")
            assert informs[0].args[4] == "3"
            _, informs = await client.request("sensor-value", "chunks-lost")
            assert informs[0].args[4] == "1"  # the gap at seq 2
        finally:
            await client.close()
            await node.stop()

    run(scenario())


def test_delay_model_update_changes_output():
    async def scenario():
        beams_out = []
        node = EngineNode(
            CFG,
            n_spectra=8,
            on_beams=lambda b, seq: beams_out.append(b),
        )
        await node.start()
        client = await Client("127.0.0.1", node.port).connect()
        try:
            chunk = make_chunk(7, node)
            node.submit_chunk(chunk, 0)
            assert await wait_for(lambda: len(beams_out) == 1, timeout=60)

            # set a beam-1 phase gradient via control and re-send same data
            vals = []
            for a in range(CFG.n_ants):
                vals += [0.0, 0.0, a * 0.7, 0.0]
            await client.request("beam-delays", 1, *vals)
            node.submit_chunk(chunk, 1)
            assert await wait_for(lambda: len(beams_out) == 2, timeout=60)

            b0, b1 = beams_out
            # beam 0 unchanged, beam 1 changed by the new steering phases
            np.testing.assert_allclose(
                b1[..., 0, :], b0[..., 0, :], rtol=1e-5, atol=1e-3
            )
            assert np.abs(b1[..., 1, :] - b0[..., 1, :]).max() > 1.0

            with pytest.raises(FailReply):
                await client.request("beam-delays", 99, *vals)
            with pytest.raises(FailReply):
                await client.request("delay-model", 1.0)
        finally:
            await client.close()
            await node.stop()

    run(scenario())


def test_delay_rate_rotates_beams_over_time():
    """Nonzero phase_rate measurably rotates beams across the stream.

    The hot-path time extrapolation of the native grouped-timestamps
    kernel (BeamformerKernels.cu:121-189): steering planes are
    regenerated from the polynomial *rates* at the coefficient-update
    cadence, with t advancing by the chunk duration. A uniform
    phase_rate r on every antenna of beam 1 rotates that beam's output
    by exactly e^{i·r·Δt} per chunk (identical input data), while beam 0
    stays fixed.
    """

    async def scenario():
        beams_out = []
        node = EngineNode(
            CFG,
            n_spectra=8,
            on_beams=lambda b, seq: beams_out.append((seq, b)),
            coeff_update_steps=1,  # re-extrapolate every chunk
        )
        await node.start()
        client = await Client("127.0.0.1", node.port).connect()
        try:
            chunk_dur = 8 * CFG.fft_size * CFG.sample_period
            rate = 0.5 / chunk_dur  # 0.5 rad of rotation per chunk
            vals = []
            for _ in range(CFG.n_ants):
                vals += [0.0, 0.0, 0.0, rate]
            await client.request("beam-delays", 1, *vals)

            chunk = make_chunk(11, node)
            for seq in range(4):
                node.submit_chunk(chunk, seq)
            assert await wait_for(lambda: len(beams_out) == 4, timeout=60)

            def beam_c(i, b):
                arr = beams_out[i][1][..., b, :]
                return arr[..., 0] + 1j * arr[..., 1]

            # beam 0 (zero rates): identical every chunk
            np.testing.assert_allclose(
                beam_c(3, 0), beam_c(0, 0), rtol=1e-5, atol=1e-3
            )
            # beam 1: rotated by k·0.5 rad after k chunks (epoch = seq 0)
            ref = beam_c(0, 1)
            strong = np.abs(ref) > np.percentile(np.abs(ref), 90)
            for k in (1, 2, 3):
                ratio = beam_c(k, 1)[strong] / ref[strong]
                angles = np.angle(ratio)
                assert np.abs(np.exp(1j * angles) - np.exp(1j * 0.5 * k)).max() < 1e-2
                np.testing.assert_allclose(np.abs(ratio), 1.0, atol=1e-2)
        finally:
            await client.close()
            await node.stop()

    run(scenario())


def test_capture_stop_pauses_processing():
    async def scenario():
        beams_out = []
        node = EngineNode(
            CFG, n_spectra=8, on_beams=lambda b, s: beams_out.append(s),
        )
        await node.start()
        client = await Client("127.0.0.1", node.port).connect()
        try:
            await client.request("capture-stop")
            node.submit_chunk(make_chunk(0, node), 0)
            await asyncio.sleep(1.0)
            n_stopped = len(beams_out)
            await client.request("capture-start")
            node.submit_chunk(make_chunk(1, node), 1)
            assert await wait_for(lambda: len(beams_out) > n_stopped, timeout=60)
        finally:
            await client.close()
            await node.stop()

    run(scenario())


def test_ring_overrun_counts_drops():
    async def scenario():
        node = EngineNode(CFG, n_spectra=8, ring_slots=2)
        # do NOT start: ring fills with no consumer
        data = make_chunk(0, node)
        assert node.submit_chunk(data, 0)
        assert node.submit_chunk(data, 1)
        assert not node.submit_chunk(data, 2)  # full -> dropped
        assert node.ring.stats()[2] == 1
        node.ring.close()

    run(scenario())


def test_beam_weights_scale_output():
    """?beam-weights scales antennas into the steering planes."""

    async def scenario():
        beams_out = []
        node = EngineNode(
            CFG, n_spectra=8, on_beams=lambda b, s: beams_out.append(b),
        )
        await node.start()
        client = await Client("127.0.0.1", node.port).connect()
        try:
            chunk = make_chunk(5, node)
            node.submit_chunk(chunk, 0)
            assert await wait_for(lambda: len(beams_out) == 1, timeout=60)
            # halve every antenna weight -> beams halve exactly
            await client.request("beam-weights", *([0.5] * CFG.n_ants))
            node.submit_chunk(chunk, 1)
            assert await wait_for(lambda: len(beams_out) == 2, timeout=60)
            np.testing.assert_allclose(
                beams_out[1], 0.5 * beams_out[0], rtol=1e-4, atol=1e-3
            )
        finally:
            await client.close()
            await node.stop()

    run(scenario())


def test_device_quantised_beam_output():
    """beam_quant_scale: device emits int8 beams == host requant of f32."""
    from dpdk_dc_sand_tpu.golden.requant import requantise
    from dpdk_dc_sand_tpu.stream.feed import UdpBeamEgress

    async def scenario():
        f32_out, int8_out = [], []
        node_f32 = EngineNode(
            CFG, n_spectra=8, on_beams=lambda b, s: f32_out.append(b),
        )
        node_i8 = EngineNode(
            CFG, n_spectra=8, on_beams=lambda b, s: int8_out.append(b), beam_quant_scale=0.25,
        )
        await node_f32.start()
        await node_i8.start()
        try:
            chunk = make_chunk(11, node_f32)
            node_f32.submit_chunk(chunk, 0)
            node_i8.submit_chunk(chunk, 0)
            assert await wait_for(
                lambda: len(f32_out) == 1 and len(int8_out) == 1, timeout=60
            )
            assert int8_out[0].dtype == np.int8
            np.testing.assert_array_equal(
                int8_out[0], requantise(f32_out[0], 0.25)
            )
        finally:
            await node_f32.stop()
            await node_i8.stop()

    run(scenario())

    # egress wiring: int8-node egress ships device bytes untouched
    sent = []

    class FakeSender:
        def send_chunk(self, chunk):
            sent.append(chunk)

    egress = UdpBeamEgress(FakeSender(), samples_per_chunk=16, scale=None)
    beams = np.arange(-8, 8, dtype=np.int8).reshape(4, 4)
    egress(beams, seq=3)
    np.testing.assert_array_equal(
        np.asarray(sent[0].payload).view(np.int8), beams.ravel()
    )
    with pytest.raises(TypeError):
        egress(beams.astype(np.float32), seq=4)


def test_visibility_egress_end_to_end():
    """ADC heaps in over UDP -> FXB node -> integrated visibility dumps
    out over UDP, matching golden correlation of the F-stage output.

    Completes the egress story: beams (int8 SPEAD heaps) and X-engine
    visibility dumps both reach the wire from one node.
    """
    from dpdk_dc_sand_tpu import golden
    from dpdk_dc_sand_tpu.models import FEngine
    from dpdk_dc_sand_tpu.stream import Chunk, ChunkRing, UdpReceiver, UdpSender

    n_in = CFG.n_ants * CFG.n_pols
    vis_bytes = CFG.n_channels * n_in * n_in * 2 * 4

    async def scenario():
        beams_out = []
        node = EngineNode(
            CFG,
            n_spectra=8,
            emit_visibilities=True,
            vis_accum_steps=2,
            on_beams=lambda b, s: beams_out.append(s),
        )
        rx = node.attach_udp_ingest()
        vis_ring = ChunkRing(8, vis_bytes + 64)
        vis_rx = UdpReceiver(("127.0.0.1", 0), vis_ring).start()
        node.attach_udp_vis_egress(("127.0.0.1", vis_rx.port))
        await node.start()
        tx = UdpSender(("127.0.0.1", rx.port))
        try:
            chunks = [make_chunk(seq, node) for seq in range(4)]
            for seq, adc in enumerate(chunks):
                tx.send_chunk(Chunk(adc.reshape(-1).view(np.uint8), seq=seq))
            dumps = []
            deadline = time.monotonic() + 60
            while len(dumps) < 2 and time.monotonic() < deadline:
                item = vis_ring.acquire_read()
                if item is None:
                    await asyncio.sleep(0.05)
                    continue
                view, seq = item
                payload = UdpReceiver.unpack(view).payload
                vis = np.ascontiguousarray(payload).view("<f4").reshape(
                    CFG.n_channels, n_in, n_in, 2
                )
                dumps.append((seq, vis.copy()))
                vis_ring.release_read()
            assert [s for s, _ in dumps] == [0, 2]  # window first-seqs
            assert len(beams_out) == 4  # beams emitted every chunk too

            # golden: correlate the F-stage output of each window's chunks
            fe = FEngine(CFG, n_spectra=8)
            zi = np.zeros(CFG.n_ants, np.int32)
            zf = np.zeros(CFG.n_ants, np.float32)
            for w, (first_seq, vis) in enumerate(dumps):
                want_re = np.zeros((CFG.n_channels, n_in, n_in), np.float64)
                want_im = np.zeros_like(want_re)
                for adc in chunks[2 * w : 2 * w + 2]:
                    quant = np.asarray(fe(adc, zi, zf, zf))  # [A,P,S,C,2]
                    x = quant.transpose(3, 2, 0, 1, 4).reshape(
                        CFG.n_channels, 8, n_in, 2
                    )
                    r, i = golden.correlate_planar(x[..., 0], x[..., 1])
                    want_re += r
                    want_im += i
                np.testing.assert_allclose(
                    vis[..., 0], want_re, rtol=1e-4, atol=1e-3
                )
                np.testing.assert_allclose(
                    vis[..., 1], want_im, rtol=1e-4, atol=1e-3
                )
        finally:
            tx.close()
            vis_rx.stop()
            vis_ring.close()
            await node.stop()

    run(scenario())


def test_udp_ingest_to_udp_egress_end_to_end():
    """ADC heaps in over UDP -> pipeline -> beam heaps out over UDP."""
    from dpdk_dc_sand_tpu.stream import Chunk, ChunkRing, UdpReceiver, UdpSender
    from dpdk_dc_sand_tpu.stream.spead import HeapAssembler

    async def scenario():
        node = EngineNode(CFG, n_spectra=8)
        rx = node.attach_udp_ingest()
        # beam capture: a receiver on the egress side
        beam_ring = ChunkRing(8, 2 * 128 * 8 * 2 * 2 + 64)
        beam_rx = UdpReceiver(("127.0.0.1", 0), beam_ring).start()
        node.attach_udp_egress(("127.0.0.1", beam_rx.port))
        await node.start()
        tx = UdpSender(("127.0.0.1", rx.port))
        try:
            for seq in range(3):
                adc = make_chunk(seq, node)
                tx.send_chunk(Chunk(adc.reshape(-1).view(np.uint8), seq=seq))
            got = []
            deadline = time.monotonic() + 60
            while len(got) < 3 and time.monotonic() < deadline:
                item = beam_ring.acquire_read()
                if item is None:
                    await asyncio.sleep(0.05)
                    continue
                view, seq = item
                payload = UdpReceiver.unpack(view).payload
                beams = np.ascontiguousarray(payload).view(np.int8).reshape(
                    2, 128, 8, 2, 2
                )
                got.append((seq, beams))
                beam_ring.release_read()
            assert [s for s, _ in got] == [0, 1, 2]
            assert all(np.isfinite(b).all() and b.any() for _, b in got)
        finally:
            tx.close()
            beam_rx.stop()
            beam_ring.close()
            await node.stop()

    run(scenario())


def test_delay_model_rejects_out_of_budget_coarse():
    """?delay-model coarse values beyond the node's budget fail loudly
    instead of being silently clipped inside the kernel."""

    async def scenario():
        node = EngineNode(CFG, n_spectra=4, margin=32)
        await node.start()
        client = await Client("127.0.0.1", node.port).connect()
        try:
            ok = [3.0, 0.0, 0.0, 0.0] * CFG.n_ants
            await client.request("delay-model", *ok)
            bad = [500.0, 0.0, 0.0, 0.0] * CFG.n_ants
            with pytest.raises(FailReply):
                await client.request("delay-model", *bad)
        finally:
            await client.close()
            await node.stop()

    run(scenario())


def test_engine_node_ingests_spead64():
    """EngineNode's UDP ingest accepts the real SPEAD-64-48 wire format
    (dual-stack receiver): a spead2-style sender can feed a node."""

    async def scenario():
        beams = []
        cfg = ArrayConfig(n_ants=2, n_channels=128, n_beams=2, n_taps=4)
        node = EngineNode(
            cfg, n_spectra=4,
            on_beams=lambda b, seq: beams.append((seq, b.copy())),
        )
        rx = node.attach_udp_ingest()
        await node.start()
        try:
            from dpdk_dc_sand_tpu.stream import Chunk, UdpSender

            rng = np.random.default_rng(3)
            adc = rng.integers(-64, 64, node.chunk_shape, dtype=np.int8)
            tx = UdpSender(("127.0.0.1", rx.port), wire_format="spead64")
            seq = 0
            while not beams and seq < 50:
                tx.send_chunk(
                    Chunk(adc.view(np.uint8).ravel(), seq=seq, timestamp=seq)
                )
                seq += 1
                await asyncio.sleep(0.2)
            tx.close()
            assert beams, "no beams emitted from spead64-fed ingest"
        finally:
            await node.stop()

    run(scenario())
