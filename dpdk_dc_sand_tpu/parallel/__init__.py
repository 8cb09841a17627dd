"""Distributed execution over a named device mesh (the reference's L4+§2.7).

The reference scales by channel-sharding engines over hosts via multicast
subscription (xeng_id, coeff_generator.py:49-53), reduces over antennas
with warp shuffles (BeamformerKernels.cu:318-341), and splits time into
blocks (BeamformerParameters.h:44-51). The JAX equivalents
(SURVEY.md §5.8 translation):

- channel sharding  → mesh axis + ``all_to_all`` corner turn
- antenna reduction → ``psum`` over an antenna-sharded axis
- time-block split  → sequence sharding with ``ppermute`` overlap-save
  halo exchange for the PFB FIR
"""

from dpdk_dc_sand_tpu.parallel.mesh import make_mesh, factor_devices  # noqa: F401
from dpdk_dc_sand_tpu.parallel.fbengine_sharded import ShardedFBEngine  # noqa: F401
from dpdk_dc_sand_tpu.parallel.ingest import (  # noqa: F401
    assemble_global,
    initialize_multihost,
    scatter_local,
    shard_indices,
)
