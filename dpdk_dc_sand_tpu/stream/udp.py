"""UDP transport for SPEAD-lite heaps (kernel sockets).

The reference's 100 GbE kernel-bypass planes (DPDK extbuf TX
dpdk_send.cpp:252-315, rte_flow RX dpdk_recv.cpp:204-254, ibverbs raw QPs)
are NIC-specific; the portable contract they implement is: multicast-able
UDP datagrams carrying sequence-numbered heap fragments, receiver-side
reassembly, drop accounting, per-second rate reports. This module provides
that contract over ordinary sockets — the host-side stream plane between
engines when a real network is present (within one host, use ChunkRing
directly).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Optional, Tuple

import numpy as np

from dpdk_dc_sand_tpu.stream.chunk import Chunk
from dpdk_dc_sand_tpu.stream.feed import RateReporter
from dpdk_dc_sand_tpu.stream.ring import ChunkRing
from dpdk_dc_sand_tpu.stream.spead import HEADER_BYTES, HeapAssembler, packetize
from dpdk_dc_sand_tpu.stream.spead64 import (
    MAGIC as SPEAD64_MAGIC,
    Heap64Assembler,
    packetize64,
)


def _is_multicast(addr: str) -> bool:
    try:
        first = int(addr.split(".")[0])
    except ValueError:
        return False
    return 224 <= first <= 239


class UdpSender:
    """Packetize chunks and transmit as UDP datagrams.

    Multicast destinations get TTL/loopback options set (the IGMP-join
    counterpart of dpdk_recv.cpp:24-56 lives in :class:`UdpReceiver`).

    ``pace_gbps`` caps the wire rate, as a digitiser's fixed sample rate
    does: a heap larger than the receiver's socket buffer is otherwise
    sent faster than :class:`UdpReceiver` drains it, and packets drop.
    ``None`` sends as fast as the socket takes them.
    """

    def __init__(
        self,
        dest: Tuple[str, int],
        mtu_payload: int = 4096,
        reporter: Optional[RateReporter] = None,
        wire_format: str = "lite",
        pace_gbps: Optional[float] = None,
    ) -> None:
        if wire_format not in ("lite", "spead64"):
            raise ValueError(f"unknown wire_format {wire_format!r}")
        if pace_gbps is not None and pace_gbps <= 0:
            raise ValueError("pace_gbps must be positive")
        self.pace_gbps = pace_gbps
        self.dest = dest
        self.mtu_payload = mtu_payload
        self.reporter = reporter
        #: "lite" = the fixed-header fast path (native packetizer);
        #: "spead64" = real SPEAD-64-48 for spead2 interoperability.
        self.wire_format = wire_format
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        if _is_multicast(dest[0]):
            self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 1)
            self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        self.sent_packets = 0
        self.sent_bytes = 0

    def send_chunk(self, chunk: Chunk) -> None:
        if self.wire_format == "spead64":
            pkts = packetize64(
                chunk.payload,
                heap_cnt=chunk.seq,
                timestamp=chunk.timestamp,
                channel_offset=chunk.channel_offset,
                mtu_payload=self.mtu_payload,
            )
        else:
            pkts = packetize(
                chunk.payload,
                heap_id=chunk.seq,
                timestamp=chunk.timestamp,
                channel_offset=chunk.channel_offset,
                mtu_payload=self.mtu_payload,
            )
        t0, sent = time.monotonic(), 0
        for i, pkt in enumerate(pkts):
            self.sock.sendto(pkt, self.dest)
            self.sent_packets += 1
            self.sent_bytes += len(pkt)
            sent += len(pkt)
            if self.pace_gbps is not None and i % 64 == 63:
                ahead = t0 + sent * 8 / (self.pace_gbps * 1e9) - time.monotonic()
                if ahead > 0:
                    time.sleep(ahead)
        if self.reporter is not None:
            self.reporter.account(chunk.payload.nbytes)

    def close(self) -> None:
        self.sock.close()


class UdpReceiver:
    """Receive datagrams, reassemble heaps, deliver chunks into a ring.

    A background thread drains the socket (the RX burst loop analog); the
    consumer reads completed chunks from ``ring`` with the usual
    acquire/release discipline. Multicast groups are joined via
    IP_ADD_MEMBERSHIP exactly as the reference must on a bifurcated driver
    (dpdk_recv.cpp:24-56).
    """

    def __init__(
        self,
        bind: Tuple[str, int],
        ring: ChunkRing,
        mtu_payload: int = 4096,
        group: Optional[str] = None,
        reporter: Optional[RateReporter] = None,
    ) -> None:
        self.ring = ring
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # Deep receive buffer: the kernel-socket stand-in for the
        # reference's 2048-deep RX descriptor rings (ibverbs_rx.c:155-217);
        # without it bursts overflow the default ~200 KiB rcvbuf.
        try:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
        except OSError:
            pass
        self.sock.bind(bind)
        # Multi-group subscription: each engine joins exactly the
        # multicast streams whose channel slices it owns — the wire-level
        # xeng_id sharding ("subscribe to multiple multicast streams",
        # ibverbs_rx.c:207-210). A str joins one group; a list joins all.
        groups = (
            [] if group is None else [group] if isinstance(group, str) else list(group)
        )
        self.groups = [g for g in groups if _is_multicast(g)]
        for g in self.groups:
            mreq = struct.pack(
                "4s4s", socket.inet_aton(g), socket.inet_aton("0.0.0.0")
            )
            self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
        self.sock.setblocking(False)
        # Dual-stack ingest: SPEAD-lite on the fast path, real
        # SPEAD-64-48 for spead2 senders — dispatched per packet on the
        # protocol magic, so one engine port accepts either format.
        self.assembler = HeapAssembler(
            mtu_payload=mtu_payload, on_chunk=self._deliver
        )
        self.assembler64 = Heap64Assembler(on_chunk=self._deliver)
        self.reporter = reporter
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.sock.getsockname()[1]

    def _deliver(self, chunk: Chunk) -> None:
        meta = np.empty(2, np.uint64)
        meta[0] = chunk.timestamp
        meta[1] = chunk.channel_offset
        payload = np.concatenate([meta.view(np.uint8), chunk.payload])
        self.ring.put(payload, chunk.seq)
        if self.reporter is not None:
            self.reporter.account(chunk.payload.nbytes)

    @staticmethod
    def unpack(view: np.ndarray) -> Chunk:
        """Recover the Chunk (metadata prefix + payload) from a ring slot."""
        meta = view[:16].view(np.uint64)
        return Chunk(
            payload=view[16:],
            seq=-1,  # ring carries the seq alongside the slot
            timestamp=int(meta[0]),
            channel_offset=int(meta[1]),
        )

    def start(self) -> "UdpReceiver":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        # Burst-drain + interrupt-driven idle wait, the dpdk_recv pattern
        # (dpdk_recv.cpp:190-244): spin through whatever is queued
        # (non-blocking recv = the rx_burst loop), and when a "burst"
        # comes back empty, sleep in epoll until the NIC interrupt—here
        # the socket readable event—fires (2 ms there, 50 ms here only
        # to bound the stop-flag latency; the wakeup itself is
        # event-driven, not a poll).
        import selectors

        sel = selectors.DefaultSelector()
        sel.register(self.sock, selectors.EVENT_READ)
        try:
            while not self._stop.is_set():
                try:
                    pkt = self.sock.recv(65536)
                except BlockingIOError:
                    sel.select(timeout=0.05)  # idle: epoll_wait analog
                    continue
                except OSError:
                    break
                if pkt[:1] == bytes((SPEAD64_MAGIC,)):
                    self.assembler64.feed(pkt)
                else:
                    self.assembler.feed(pkt)
        finally:
            sel.close()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.sock.close()
