"""Host streaming layer (L4 transport contract).

The reference moves sample/beam streams as UDP-multicast SPEAD heaps over
kernel-bypass NICs (SURVEY.md §5.8). Here the data plane is
host memory → device memory, but the *contract* carries over unchanged:

- chunked, sequence-numbered payloads with timestamps and channel offsets
  (:mod:`~dpdk_dc_sand_tpu.stream.spead`),
- preallocated zero-copy ring buffers with explicit completion/reuse
  signalling and drop accounting (:mod:`~dpdk_dc_sand_tpu.stream.ring`),
- double-buffered async device feed and egress with per-second rate
  reporting (:mod:`~dpdk_dc_sand_tpu.stream.feed`),
- a real UDP transport for host↔host streams
  (:mod:`~dpdk_dc_sand_tpu.stream.udp`).
"""

from dpdk_dc_sand_tpu.stream.chunk import Chunk, StreamStats  # noqa: F401
from dpdk_dc_sand_tpu.stream.ring import ChunkRing  # noqa: F401
from dpdk_dc_sand_tpu.stream.spead import (  # noqa: F401
    HEADER_BYTES,
    HeapAssembler,
    packetize,
    parse_header,
)
from dpdk_dc_sand_tpu.stream.spead64 import (  # noqa: F401
    Heap64Assembler,
    packetize64,
    parse_packet64,
    stream_stop_packet,
)
from dpdk_dc_sand_tpu.stream.feed import DeviceFeed, RateReporter  # noqa: F401
from dpdk_dc_sand_tpu.stream.udp import UdpReceiver, UdpSender  # noqa: F401
