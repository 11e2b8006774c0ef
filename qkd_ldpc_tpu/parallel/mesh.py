"""Device mesh construction and sharding helpers.

The reference's entire parallelism story is a single-process CPU thread
pool fork-joined over Monte-Carlo trials (``BS::thread_pool``,
``src/simulation.cpp:230-250``).  The device-mesh equivalents (SURVEY.md §2
"Parallelism strategies"); a mesh is a plain reshape of ``jax.devices()``:

- ``trial`` axis — data parallelism over independent frames/trials across
  all devices.  Communication: one psum of seven stat scalars per batch.
- ``node`` axis — intra-frame model parallelism: variable nodes of one
  huge frame split across devices, check-node reductions over cut edges via
  collectives (see ``qkd_ldpc_tpu.parallel.node_sharded``).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TRIAL_AXIS = "trial"
NODE_AXIS = "node"


def make_trial_mesh(devices=None) -> Mesh:
    """1-D mesh over all devices: pure trial/data parallelism."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (TRIAL_AXIS,))


def make_mesh(n_trial: int | None = None, n_node: int = 1, devices=None) -> Mesh:
    """2-D (trial, node) mesh.  ``n_node`` chips cooperate on one frame;
    the remaining factor runs independent trial shards."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if n % n_node:
        raise ValueError(f"n_node={n_node} does not divide device count {n}")
    n_trial = n_trial if n_trial is not None else n // n_node
    if n_trial * n_node != n:
        raise ValueError(f"{n_trial} x {n_node} != {n} devices")
    return Mesh(devices.reshape(n_trial, n_node), (TRIAL_AXIS, NODE_AXIS))


def trial_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding over the trial axis."""
    return NamedSharding(mesh, P(TRIAL_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def initialize_distributed(**kwargs) -> None:
    """Multi-host process-group bring-up (no-op when single-host).

    The reference has no distributed backend at all.  Callers pass the
    coordinator address, process count and process id explicitly (no
    cluster environment is discovered); the multi-process CLI path gives
    each process one GPU.
    """
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        # Only the benign re-initialization case is swallowed; a genuine
        # bring-up failure (bad coordinator address, port conflict,
        # mismatched num_processes) must surface — silently degrading to
        # independent single-host runs would duplicate the whole sweep.
        if "already initialized" not in str(e).lower():
            raise
