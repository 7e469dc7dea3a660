"""Multi-host runtime: initialization, heartbeat, recovery (aux subsystem,
SURVEY.md §5 "failure detection / elastic recovery").

Multi-host jobs are SPMD gang-scheduled: every process runs the same
program over a global mesh. Failure handling is accordingly minimal and
explicit (matching the reference's scope, which has none at all):

- :func:`initialize` wraps ``jax.distributed.initialize`` with a timeout —
  a missing peer surfaces as an init failure rather than a silent hang;
- :func:`heartbeat` is a ``psum`` of ones over all devices — it both
  verifies that the gang is alive and measures collective latency;
- recovery = restart from a checkpoint (``spalinalg.io.save_npz`` /
  ``load_npz`` per-shard). No elasticity.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp

__all__ = ["initialize", "heartbeat", "global_device_summary"]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    timeout_s: int = 300,
) -> None:
    """Initialize the multi-host runtime (no-op for single-process runs).

    Raises ``RuntimeError`` if the gang does not assemble within
    ``timeout_s`` (the SPMD failure-detection contract: fail fast at the
    barrier, don't hang).
    """
    if num_processes in (None, 0, 1):
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            initialization_timeout=timeout_s,
        )
    except Exception as e:  # surface as a detection event
        raise RuntimeError(
            f"distributed initialization failed after {timeout_s}s — "
            f"gang incomplete or coordinator unreachable: {e}"
        ) from e


def heartbeat(timeout_s: float = 60.0) -> float:
    """All-device liveness barrier; returns the collective latency in
    seconds. A dead/partitioned peer turns this into a timeout/error."""
    n = len(jax.devices())
    t0 = time.perf_counter()
    out = jax.pmap(lambda x: jax.lax.psum(x, "i"), axis_name="i")(
        jnp.ones((jax.local_device_count(),))
    )
    val = float(out[0])
    dt = time.perf_counter() - t0
    if val != n:
        raise RuntimeError(
            f"heartbeat psum returned {val}, expected {n}: gang degraded"
        )
    if dt > timeout_s:
        raise RuntimeError(f"heartbeat took {dt:.1f}s (> {timeout_s}s)")
    return dt


def global_device_summary() -> dict:
    """Structured snapshot for logs: process/device topology."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": [str(d) for d in jax.local_devices()],
        "global_device_count": len(jax.devices()),
    }
