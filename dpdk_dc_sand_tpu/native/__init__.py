"""Native (C++) runtime components, loaded via ctypes.

The reference keeps its transport and characterisation hot paths in
C/C++ (dpdk_send_recv/, ibverbs_sample_project/, utilities/); this package
does the same for the accelerator host runtime: an SPSC chunk ring buffer, the
SPEAD-lite packet codec, and the RAM-bandwidth scanner. Sources compile on
first use with g++ (cached as a .so next to the sources); every consumer
has a pure-Python fallback so the framework degrades gracefully without a
toolchain.
"""

from dpdk_dc_sand_tpu.native.build import load_native  # noqa: F401
