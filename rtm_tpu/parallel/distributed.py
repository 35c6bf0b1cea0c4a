"""Multi-host runtime bring-up.

The reference is strictly single-process (SURVEY.md §5.8); this is the new
surface for pod-scale runs: `jax.distributed.initialize` with retry, and a
process-local view helper.  Intra-slice gradient psums ride ICI; multi-host
crosses DCN — the sharding layer (parallel.sharding) is agnostic, it just
sees a bigger mesh.
"""
from __future__ import annotations

import logging
import time

import jax

log = logging.getLogger("rtm.parallel")


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           retries: int = 3, retry_delay_s: float = 5.0):
    """Initialize the jax distributed runtime (idempotent, with retry).

    On single-process runs (coordinator_address None and no cluster env),
    this is a no-op and returns False.  Returns True once the distributed
    client is up.
    """
    # NB: probe initialization state WITHOUT touching the backend —
    # jax.process_count() would initialize XLA and make a subsequent
    # jax.distributed.initialize() impossible.
    if jax.distributed.is_initialized():
        return True  # already initialized by the runtime
    if coordinator_address is None and num_processes is None:
        return False
    last = None
    for attempt in range(retries):
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id)
            log.info("distributed runtime up: process %d/%d",
                     jax.process_index(), jax.process_count())
            return True
        except Exception as e:  # noqa: BLE001 - retry then surface
            last = e
            log.warning("distributed init attempt %d failed: %s", attempt, e)
            time.sleep(retry_delay_s)
    raise RuntimeError(f"jax.distributed.initialize failed after "
                       f"{retries} attempts") from last


def local_device_count() -> int:
    return jax.local_device_count()


def global_device_count() -> int:
    return jax.device_count()
