"""Multi-host initialization + per-host data sharding helpers.

The reference has no distributed communication at all (SURVEY §2.3).
Multi-host SPMD needs:

1. ``jax.distributed.initialize(coordinator, num_processes, process_id)`` on
   every host;
2. a global mesh spanning all hosts' devices — XLA chooses the collectives
   from the same ``PartitionSpec`` annotations used single-host;
3. per-host input feeding: each host loads its own slice of the global
   batch and :func:`host_local_batch_to_global` assembles the global
   sharded array (``jax.make_array_from_process_local_data``).

The sharding program itself is validated by the CPU-mesh tests and
``__graft_entry__.dryrun_multichip``; ``tests/test_multihost.py`` runs two
CPU processes over a local coordinator.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils.logging import get_logger

logger = get_logger("distributed")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Idempotent ``jax.distributed.initialize``.

    Must be the FIRST jax call in the process — do not touch
    ``jax.devices()``/``jax.process_count()`` before this (they initialize
    the XLA backend and make distributed init impossible).
    """
    try:
        if coordinator_address:
            jax.distributed.initialize(coordinator_address, num_processes, process_id)
        else:
            jax.distributed.initialize()  # cluster environments JAX detects
        logger.info(
            f"distributed: process {jax.process_index()}/{jax.process_count()}, "
            f"{jax.local_device_count()} local / {jax.device_count()} global devices"
        )
    except RuntimeError as e:
        if "already initialized" in str(e).lower():
            return
        if "backend" in str(e).lower():
            raise RuntimeError(
                "initialize_distributed must run before any other JAX call "
                "(the XLA backend is already initialized)"
            ) from e
        logger.info(f"single-process mode ({e})")
    except Exception as e:  # no coordinator/env: genuine single-process runs
        logger.info(f"single-process mode ({e})")


def global_mesh(data: int = -1, model: int = 1) -> Mesh:
    """Mesh over ALL processes' devices (data-major order)."""
    from .mesh import make_mesh
    return make_mesh(data=data, model=model, devices=jax.devices())


def is_main_process() -> bool:
    return jax.process_index() == 0


def fetch_to_host(x, mesh: Optional[Mesh]) -> np.ndarray:
    """Materialize a (possibly cross-host sharded) array on every host.

    Single-process: a plain device_get. Multi-process: a jitted identity
    with replicated out_shardings (XLA all-gathers over the mesh), then the
    local replica is read — the standard way to fetch sharded eval outputs
    without assuming addressability.
    """
    if jax.process_count() == 1 or mesh is None:
        return np.asarray(jax.device_get(x))
    rep = jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))(x)
    return np.asarray(rep.addressable_data(0))


def fetch_pytree_to_host(tree, mesh: Optional[Mesh]):
    """fetch_to_host over every array leaf of a pytree (for host-format
    checkpoints of sharded state)."""
    return jax.tree.map(lambda x: fetch_to_host(x, mesh)
                        if isinstance(x, jax.Array) else x, tree)


def broadcast_str(s: str, maxlen: int = 64) -> str:
    """Agree on a short string across processes (process 0 wins). Used for
    the timestamped experiment dir name, which each process would otherwise
    compute from its own clock."""
    if jax.process_count() == 1:
        return s
    from jax.experimental import multihost_utils
    buf = np.zeros(maxlen, np.uint8)
    raw = s.encode()[:maxlen]
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    out = np.asarray(multihost_utils.broadcast_one_to_all(buf))
    return bytes(out[out != 0]).decode()


def host_local_batch_to_global(batch: Dict[str, np.ndarray], mesh: Mesh) -> Dict:
    """Assemble a global batch-sharded array from per-host local shards.

    Each host passes its local rows; the result is a global array sharded
    P('data') whose global leading dim is ``local_rows * num_hosts_on_data``.
    """
    def convert(x):
        spec = P("data", *([None] * (np.ndim(x) - 1)))
        return jax.make_array_from_process_local_data(NamedSharding(mesh, spec), x)

    return {k: convert(v) for k, v in batch.items()}
