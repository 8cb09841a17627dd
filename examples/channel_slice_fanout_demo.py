"""Channel-slice multicast fan-out demo — the wire-level xeng_id model.

The deployment topology the reference's transport prototypes exist for
(ibverbs_rx.c:207-210 "subscribe to multiple multicast streams";
coeff_generator.py:49-53 absolute-channel steering), run end to end on
one host over real multicast loopback:

  F-engine product (channelised voltages, synthesized)
    ── real SPEAD-64-48 over per-slice multicast groups ──▶
  N subscriber B-engine nodes, each joined ONLY to its groups,
    each beamforming its slice with xeng_id channel offsets
    └─▶ combined spectrum coverage check + a pcap capture of the
        fan-out analysed for send jitter (packet_latency workflow)

Here the subscribers share one process and one device. In a deployment
each subscriber node is its own process, and on a GPU host each needs a
card of its own — start each with its own ``CUDA_VISIBLE_DEVICES`` (a JAX
process reserves most of a card's memory when it first uses it).

Run: python examples/channel_slice_fanout_demo.py
"""

import time

import numpy as np

from dpdk_dc_sand_tpu.config import ArrayConfig
from dpdk_dc_sand_tpu.models import BeamformPipeline
from dpdk_dc_sand_tpu.stream import Chunk, ChunkRing, UdpReceiver, UdpSender
from dpdk_dc_sand_tpu.stream.latency import (
    extract_timestamps,
    latency_stats,
    read_pcap,
    write_pcap,
)

CFG = ArrayConfig(n_ants=4, n_channels=64, n_beams=2, n_batches=1)
GROUPS = {0: "239.102.40.1", 1: "239.102.40.2"}
ADC_RATE = 1712e6


def main() -> None:
    cps = CFG.n_channels_per_stream
    slice_bytes = (
        CFG.n_batches * CFG.n_ants * cps * CFG.n_samples_per_channel
        * CFG.n_pols * 2
    )

    # Subscriber nodes: each joins its own multicast group (bound to the
    # group address — kernel-level stream isolation) and owns one slice.
    nodes = {}
    for xeng_id, grp in GROUPS.items():
        ring = ChunkRing(8, slice_bytes + 16)
        rx = UdpReceiver((grp, 0), ring, mtu_payload=2048, group=grp).start()
        nodes[xeng_id] = (ring, rx, BeamformPipeline(CFG, xeng_id=xeng_id))

    # F-engine product: full band, fanned out per slice as REAL
    # SPEAD-64-48 heaps (spead2-interoperable), timestamped.
    rng = np.random.default_rng(2021)
    samples = rng.integers(-128, 127, size=(
        CFG.n_batches, CFG.n_ants, CFG.n_channels,
        CFG.n_samples_per_channel, CFG.n_pols, 2), dtype=np.int8)
    capture = []
    for xeng_id, grp in GROUPS.items():
        tx = UdpSender(
            (grp, nodes[xeng_id][1].port), mtu_payload=2048,
            wire_format="spead64",
        )
        payload = np.ascontiguousarray(
            samples[:, :, xeng_id * cps : (xeng_id + 1) * cps]
        )
        adc_ts = 4096 * xeng_id
        chunk = Chunk(
            payload.view(np.uint8).ravel(), seq=xeng_id,
            timestamp=adc_ts, channel_offset=CFG.channel_offset(xeng_id),
        )
        # Passive capture of the same heaps (the tcpdump analog).
        from dpdk_dc_sand_tpu.stream.spead64 import packetize64

        for pkt in packetize64(
            chunk.payload, heap_cnt=chunk.seq, timestamp=chunk.timestamp,
            channel_offset=chunk.channel_offset, mtu_payload=2048,
        ):
            capture.append((time.time(), pkt))
        tx.send_chunk(chunk)
        tx.close()

    # Each node ingests and beamforms ONLY its slice.
    dv = np.zeros(CFG.delay_vals_shape, np.float32)
    covered = []
    for xeng_id, (ring, rx, pipe) in nodes.items():
        got = None
        deadline = time.time() + 8.0
        while got is None and time.time() < deadline:
            item = ring.acquire_read()
            if item is None:
                time.sleep(0.01)
                continue
            view, seq = item
            got = UdpReceiver.unpack(view)
            ring.release_read()
        assert got is not None, f"node {xeng_id}: no heap"
        assert got.channel_offset == CFG.channel_offset(xeng_id)
        ingest = np.asarray(got.payload).view(np.int8).reshape(
            CFG.ingest_shape
        )
        beams = np.asarray(pipe(ingest, dv))
        covered.append((xeng_id, got.channel_offset, beams.shape))
        print(
            f"node {xeng_id}: channels [{got.channel_offset}, "
            f"{got.channel_offset + cps}) -> beams {beams.shape}"
        )
        rx.stop()
    assert sorted(off for _, off, _ in covered) == [0, cps]
    print(f"combined spectrum coverage: {len(covered)} slices x {cps} chan")

    # Offline capture analysis (packet_latency workflow) on the fan-out.
    write_pcap("/tmp/fanout_capture.pcap", capture)
    stats = latency_stats(
        extract_timestamps(read_pcap("/tmp/fanout_capture.pcap")),
        adc_sample_rate=ADC_RATE,
    )
    print("capture jitter stats:", stats)


if __name__ == "__main__":
    main()
