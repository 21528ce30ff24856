"""Multi-host bring-up: jax.distributed plumbing + global meshes.

The reference is strictly single-process (OpenMP threads only,
src/Scene.cpp:111-201); the BASELINE scaling target ("≥85% rays/s
efficiency from 1 chip to ≥2 hosts") needs a multi-process execution
path. This module is the only place that touches `jax.distributed`:

  * each host process calls `init_from_env()` BEFORE any jax computation;
  * `global_mesh()` builds the 1-D 'rays' mesh over the GLOBAL device list
    (all hosts), so every shard_map entry point in parallel/sharding.py
    (render_sharded, loss_and_grads_scanned(mesh=...), train_step) runs
    unmodified across hosts — XLA hands the psum/ppermute to NCCL, over
    NVLink between the GPUs of a host and the network between hosts;
  * host-local I/O helpers gather the per-host shards of a global array.

Environment contract (set by the launcher, e.g. scripts/multihost_worker.py
or a scheduler):
  RT_COORDINATOR     host:port of process 0
  RT_NUM_PROCESSES   total process count
  RT_PROCESS_ID      this process's id (0-based)
  RT_PROCS_PER_HOST  optional: processes per host, one per GPU; when set,
                     process p takes only GPU p modulo RT_PROCS_PER_HOST
  RT_CPU_DEVICES     optional: per-process virtual CPU device count (tests)

Tested end-to-end on CPU with 2 localhost processes (gloo collectives,
tests/test_multihost.py); on GPUs the same env vars drive it, one process
per GPU.
"""
from __future__ import annotations

import os

import numpy as np


def init_from_env() -> bool:
    """Initialize jax.distributed from RT_* env vars. Returns True when a
    multi-process runtime was initialized; False for single-process use.

    Must run before any jax device/computation touch. For CPU runs the
    cross-process collectives backend is set to gloo (GPUs use NCCL).
    With several processes on one GPU host, each takes only its own card
    (local_device_ids): a JAX process reserves most of a card's memory, so
    two on one card fail.
    """
    coord = os.environ.get('RT_COORDINATOR')
    if not coord:
        return False
    n_cpu = os.environ.get('RT_CPU_DEVICES')
    if n_cpu:
        os.environ['XLA_FLAGS'] = (
            os.environ.get('XLA_FLAGS', '')
            + f' --xla_force_host_platform_device_count={n_cpu}').strip()
    import jax
    if n_cpu:
        jax.config.update('jax_platforms', 'cpu')
        try:  # cross-process CPU collectives
            jax.config.update('jax_cpu_collectives_implementation', 'gloo')
        except (AttributeError, ValueError):  # pragma: no cover
            pass
    pid = int(os.environ['RT_PROCESS_ID'])
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ['RT_NUM_PROCESSES']),
        process_id=pid, local_device_ids=None if n_cpu else
        local_device_ids(pid))
    return True


def local_device_ids(pid: int) -> list[int] | None:
    """The GPU of this host that process `pid` takes (pid modulo
    RT_PROCS_PER_HOST), or None (every local device) when that is unset."""
    per_host = os.environ.get('RT_PROCS_PER_HOST')
    return [pid % int(per_host)] if per_host else None


def global_mesh(n_devices: int | None = None):
    """1-D 'rays' mesh over the GLOBAL (all-host) device list."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()  # global across processes after initialize()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), ('rays',))


def process_info() -> tuple[int, int]:
    import jax
    return jax.process_index(), jax.process_count()


def gather_image(img) -> np.ndarray | None:
    """Fetch a (possibly cross-host sharded) rendered image to process 0.

    Uses jax.experimental.multihost_utils; returns None on non-zero
    processes.
    """
    import jax
    from jax.experimental import multihost_utils

    arr = multihost_utils.process_allgather(img, tiled=True)
    return np.asarray(arr) if jax.process_index() == 0 else None
