"""dpdk_dc_sand_tpu — a JAX radio-astronomy signal-chain framework.

A from-scratch rebuild of the capabilities of SARAO's ``dc_sand`` CUDA
sandbox (reference: magnate3/dpdk_dc_sand), written in JAX and compiled
by XLA for the accelerator (an NVIDIA H100; the CPU for tests):

- F-engine: coarse delay, polyphase-filterbank channelisation (tap-sum FIR
  + XLA real FFT), fine-delay phase rotation, 8-bit requantisation.
- B-engine: steering-coefficient generation from CAM-style delay polynomials
  and multi-beam coherent beamforming as channel-batched matmuls.
- Parallelism over a named ``jax.sharding.Mesh``: channel sharding (the
  reference's ``xeng_id`` engine split), antenna sharding with ``psum`` beam
  reduction, time-block sharding with ``ppermute`` overlap-save halos.
- A host-side streaming ingest/egress layer (chunked ring buffers with
  sequence numbers and drop accounting) replacing the reference's
  DPDK/ibverbs/spead2 transport, plus a KATCP-style control/sensor plane.

Layer map (mirrors SURVEY.md §1 of the reference analysis):

- L5 control:      :mod:`dpdk_dc_sand_tpu.control`
- L4 transport:    :mod:`dpdk_dc_sand_tpu.stream`
- L3 DSP pipeline: :mod:`dpdk_dc_sand_tpu.models`
- L2 kernels/ops:  :mod:`dpdk_dc_sand_tpu.ops` (+ golden models in
  :mod:`dpdk_dc_sand_tpu.golden`)
- L1 hardware characterisation: :mod:`dpdk_dc_sand_tpu.characterize`
"""

__version__ = "0.1.0"

from dpdk_dc_sand_tpu.config import ArrayConfig, DelayModel  # noqa: F401
