"""Distributed ingest: per-host shard assembly into global device arrays.

The reference's engines each subscribe to the multicast groups carrying
their own channel slice (ibverbs_rx.c:207-210; SURVEY.md §5.8). The
JAX equivalent: every host's ingest thread produces only the shard
its local devices own, `jax.device_put`s those pieces, and
`jax.make_array_from_single_device_arrays` stitches them into the global
sharded array consumed by the jitted distributed step — no host ever
materialises the full array.

Works identically in a single process with N local devices (the test
configuration) and across real multi-host deployments, where
``sharding.addressable_devices`` restricts the work to this host's slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import jax
import numpy as np
from jax.sharding import NamedSharding


def shard_indices(
    sharding: NamedSharding, global_shape: Tuple[int, ...]
) -> Dict[jax.Device, Tuple[slice, ...]]:
    """Map each *addressable* device to its global index slices.

    The ingest side uses this to know which multicast groups / channel
    ranges / time ranges this host must subscribe to.
    """
    mapping = sharding.addressable_devices_indices_map(tuple(global_shape))
    return dict(mapping)


def assemble_global(
    provider: Callable[[Tuple[slice, ...]], np.ndarray],
    sharding: NamedSharding,
    global_shape: Tuple[int, ...],
) -> jax.Array:
    """Build a globally-sharded array from per-shard host data.

    ``provider(index)`` returns the host data for one shard (e.g. a view
    into a ring-buffer chunk for that channel/time slice); it is called
    once per addressable device. Returns a global ``jax.Array`` with
    ``sharding`` — ready to pass straight into a pjit/shard_map step.
    """
    pieces = []
    for dev, idx in shard_indices(sharding, global_shape).items():
        pieces.append(jax.device_put(np.ascontiguousarray(provider(idx)), dev))
    return jax.make_array_from_single_device_arrays(
        tuple(global_shape), sharding, pieces
    )


def scatter_local(
    local: np.ndarray, sharding: NamedSharding
) -> jax.Array:
    """Shard one host-resident array across the mesh (single-host feed).

    Convenience wrapper over :func:`assemble_global` for the case where
    the whole chunk is already in this host's memory.
    """
    return assemble_global(
        lambda idx: local[idx], sharding, tuple(local.shape)
    )


def initialize_multihost() -> bool:
    """Initialise jax's multi-host runtime when launched as one process
    of a pod (env-driven: ``JAX_COORDINATOR``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``). Returns True when distributed mode is active.

    On a single host this is a no-op — the rest of the ingest path is
    identical either way.
    """
    import os

    coord = os.environ.get("JAX_COORDINATOR")
    if not coord:
        return False
    if "cpu" in os.environ.get("JAX_PLATFORMS", ""):
        # CPU pods (the test/dev configuration) need an explicit
        # cross-process collectives backend; GPUs use NCCL.
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:  # older jaxlib without gloo: let init decide
            pass
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ.get("JAX_NUM_PROCESSES", "1")),
        process_id=int(os.environ.get("JAX_PROCESS_ID", "0")),
    )
    return True
