"""Device-mesh parallelism: particles sharded over the GPUs of a host.

Device-side replacement for the reference's process/MPI likelihood
fan-out (reference pocomc/parallel.py:20-178, sampler.py:267-274):
instead of shipping scalar likelihood calls to worker processes, the
particle axis is sharded over a 1-D `jax.sharding.Mesh` and every jitted
program (MCMC sweeps, flow training, geometry fits) runs SPMD — XLA
inserts the collectives (psum for the acceptance/plateau means and
weighted moments, all-gathers for resampling). One process drives all
the cards of a host; XLA hands the collectives to NCCL, which carries
them over NVLink. Every card reaches every other at the same rate, so
the 1-D mesh needs no topology.

The SMC algorithm's only cross-particle couplings are reductions
(SURVEY.md section 5.7), so a pure data-parallel layout is optimal: zero
resharding inside the sweep, one all-reduce per MCMC step for the
adaptation statistics.

Multi-process: call :func:`initialize_distributed` (a thin wrapper over
`jax.distributed.initialize`) in every process before constructing the
mesh — the device-mesh counterpart of the reference's `mpiexec -n N`
worker farm. This path is rehearsed on CPU devices with Gloo
collectives (parallel/smoke.py); multi-process NCCL is untested.
Host bookkeeping stays SPMD-replicated (every process runs the same
sampler loop over the same RNG stream); device arrays are globally
sharded, and black-box host likelihoods fan out per-host via
:meth:`ParticleMesh.shard_callback` — each process's Python callable
sees only its local particle rows, exactly like one MPI worker.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_count=None,
                           platform=None):
    """Connect this process to a multi-process JAX run.

    Call once per process, before any JAX computation, in every process
    of the job.  Replaces the reference's MPI bootstrap: where pocoMC
    ships pickled likelihood calls to `mpiexec` workers, here every
    process joins one global device mesh and XLA moves data over
    NCCL (or Gloo on CPU).

    Parameters
    ----------
    coordinator_address : str or None
        "host:port" of process 0. None defers to JAX's cluster
        auto-detection, which finds nothing on a plain GPU host: pass
        the address, `num_processes` and `process_id` there.
    num_processes, process_id : int or None
        Job size / this process's rank; None = auto-detect.
    local_device_count : int or None
        For CPU smoke tests only: virtual local device count (must be
        set before backend init; ignored for GPU backends).
    platform : str or None
        Force a platform ("cpu" for the smoke harness); None keeps the
        environment's backend.

    Returns
    -------
    (process_index, process_count)
    """
    if platform is not None:
        jax.config.update("jax_platforms", platform)
    if local_device_count is not None:
        try:
            jax.config.update("jax_num_cpu_devices", local_device_count)
        except RuntimeError:
            pass  # backend already initialized; keep its device count
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_index(), jax.process_count()


class ParticleMesh:
    """1-D mesh over which particle-major arrays are sharded.

    Parameters
    ----------
    devices : list of jax devices or None
        Defaults to all visible devices.
    """

    def __init__(self, devices=None):
        if devices is None:
            devices = jax.devices()
        self.devices = list(devices)
        self.mesh = Mesh(np.array(self.devices), ("particles",))
        self.particle_spec = P("particles")
        self.particle_sharding = NamedSharding(self.mesh, self.particle_spec)
        self.replicated = NamedSharding(self.mesh, P())
        # diagnostic: how many shard_particles calls fell back to
        # replication because the row count didn't divide the mesh
        # (tests assert the fallback path actually runs inside full runs)
        self.replication_fallbacks = 0

    @property
    def size(self):
        return len(self.devices)

    @property
    def multihost(self):
        """True when the mesh spans more than one process."""
        return jax.process_count() > 1

    def _put(self, arr, sharding, axis):
        """device_put with multi-host support: every process is assumed
        to hold the identical full host array (replicated host SPMD, the
        multi-host usage contract), and contributes only the rows its
        local devices own."""
        if not self.multihost:
            return jax.device_put(arr, sharding)
        arr = np.asarray(arr)
        return jax.make_array_from_process_local_data(
            sharding, arr, global_shape=arr.shape)

    def shard_particles(self, arr):
        """Place a particle-major array (first axis = particles) sharded.
        Row counts not divisible by the mesh size (e.g. pow2-padded
        training sets on a non-pow2 mesh) fall back to replication —
        always correct, just unsharded."""
        if np.shape(arr)[0] % self.size != 0:
            self.replication_fallbacks += 1
            return self._put(arr, self.replicated, axis=None)
        return self._put(arr, self.particle_sharding, axis=0)

    def shard_history(self, hist_tree):
        """Place slot-major (T_max, n[, d]) history buffers with the
        particle axis (axis 1) sharded and the per-slot scalars
        replicated — the device-resident SMC loop's layout
        (sampler._run_device_loop). Multi-host safe: every process holds
        the identical full host copy and contributes its local rows."""
        sh = NamedSharding(self.mesh, P(None, "particles"))
        return jax.tree_util.tree_map(
            lambda a: (self._put(np.asarray(a), sh, axis=1)
                       if getattr(a, "ndim", 0) >= 2
                       else self._put(np.asarray(a), self.replicated,
                                      axis=None)),
            hist_tree)

    def shard_batches(self, arr):
        """Place a (n_batches, batch, ...) training stack with the batch
        axis sharded."""
        sh = NamedSharding(self.mesh, P(None, "particles"))
        return self._put(arr, sh, axis=1)

    def replicate(self, tree):
        """Replicate a pytree (flow params, geometry) on every device."""
        if not self.multihost:
            return jax.device_put(tree, self.replicated)
        return jax.tree_util.tree_map(
            lambda a: jax.make_array_from_process_local_data(
                self.replicated, np.asarray(a),
                global_shape=np.shape(a)), tree)

    def gather(self, garr):
        """Full host copy of a (possibly multi-host) global array on
        every process — the reverse of shard_particles."""
        if not self.multihost and getattr(garr, "is_fully_addressable", True):
            return np.asarray(jax.device_get(garr))
        from jax.experimental import multihost_utils
        return np.asarray(
            multihost_utils.process_allgather(garr, tiled=True))

    def shard_callback(self, loglike, n_out_per_row: int = 1):
        """Per-host fan-out for a black-box `loglike(x, mask) -> logl`
        host callback (mcmc.make_loglike_device, callback path): wraps
        it in `jax.shard_map` over the particle axis so each process's
        Python function is invoked once per local device with ONLY the
        rows that device owns — the device-mesh analog of the reference
        distributing likelihood batches to MPI workers
        (reference pocomc/parallel.py:129-158).

        The wrapped callable has the same (x, mask) -> logl signature
        and is safe inside jit."""
        def sharded(x, mask):
            return jax.shard_map(
                loglike, mesh=self.mesh,
                in_specs=(self.particle_spec, self.particle_spec),
                out_specs=self.particle_spec)(x, mask)
        return sharded

    def pad_to_multiple(self, n: int) -> int:
        """Smallest multiple of the mesh size >= n."""
        k = self.size
        return ((n + k - 1) // k) * k
