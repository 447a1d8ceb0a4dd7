"""Multi-process (multi-host) smoke harness: a CPU rehearsal with Gloo.

The reference's scale-out story is `mpiexec -n N python script.py` with an
MPIPool shipping pickled likelihood calls to workers
(reference pocomc/parallel.py:20-178, docs/source/parallelization.ipynb
"MPI").  The device-mesh equivalent is one global `jax.sharding.Mesh`
spanning every process, so the "does multi-process actually run?" check
is: N OS processes, each owning a slice of devices, joining one mesh and
executing the framework's real programs.  This module is that check on
CPU devices with Gloo collectives; the same path over NCCL on GPUs is
untested:

    python -m pocomc_tpu.parallel.smoke            # 2 procs x 2 devices
    python -m pocomc_tpu.parallel.smoke 4 2        # 4 procs x 2 devices
    python -m pocomc_tpu.parallel.smoke 4 1 core,dev   # case subset

Each worker runs, over the GLOBAL mesh:
  1. a sharded reduction (device_put path + psum correctness),
  2. a black-box host likelihood through ParticleMesh.shard_callback —
     verifying each process's Python function sees ONLY local rows,
  3. the real adaptive t-pCN sweep program (mcmc.make_sweep) on sharded
     particles, gathered and checksummed — every process must agree,
  4. a full end-to-end `Sampler.run()` with a traceable likelihood (the
     device-resident SMC loop, history sharded over the global mesh),
  5. a full `Sampler.run()` with a BLACK-BOX likelihood (host
     orchestration; per-process likelihood fan-out via shard_callback —
     the reference's `mpiexec -n N` user contract,
     /root/reference/pocomc/parallel.py:20-178),
  6. a mid-run `save_every` checkpoint under the mesh (rank-0-only
     atomic write) resumed by a FRESH Sampler that runs to completion.
All executed checksums fold into one value every process must match.

`launch()` spawns the workers and validates their output; the pytest
suite (tests/test_multihost.py) and __graft_entry__.dryrun_multichip's
multi-process mode both drive it.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_worker(process_id: int, num_processes: int, port: int,
               n_local: int = 2, cases: str = "all") -> None:
    """Body of one multi-host process (CPU backend, Gloo collectives).

    `cases` selects which checks run (comma-separated, or "all"):
      core   — checks 1-3 (reduction, callback fan-out, sweep program)
      dev    — check 4 (full Sampler.run, device loop)
      host   — check 5 (full Sampler.run, black-box likelihood; also
               asserts the ParticleMesh replication fallback fired on the
               trimmed — data-dependent, mesh-indivisible — training rows)
      resume — check 6 (mid-run save_every checkpoint under the mesh,
               then a FRESH Sampler resumes from it and finishes)
    """
    want = (("core", "dev", "host", "resume") if cases == "all"
            else tuple(cases.split(",")))
    from pocomc_tpu.parallel.mesh import ParticleMesh, initialize_distributed

    rank, count = initialize_distributed(
        f"localhost:{port}", num_processes, process_id,
        local_device_count=n_local, platform="cpu")
    assert count == num_processes and rank == process_id

    import jax
    import jax.numpy as jnp
    import numpy as np
    from pocomc_tpu.mcmc import make_loglike_device, make_sweep
    from pocomc_tpu.models.geometry import fit_geometry_jax
    from pocomc_tpu.prior import Normal, Prior
    from pocomc_tpu.scaler import Reparameterize

    mesh = ParticleMesh()
    assert mesh.multihost and mesh.size == num_processes * n_local
    n = 16 * mesh.size
    n_dim = 3
    checksum = 0.0
    seen: list[int] = [0]
    sweep_steps = 0

    if "core" in want:
        # 1. sharded reduction over the global mesh
        total = float(mesh.gather(jax.jit(
            jnp.sum, out_shardings=mesh.replicated)(
                mesh.shard_particles(np.arange(n, dtype=np.float32)))))
        assert total == n * (n - 1) / 2, total

        # 2. black-box likelihood fan-out: local rows only
        seen = []

        def host_like(x):
            seen.append(x.shape[0])
            return -0.5 * np.sum(np.asarray(x) ** 2, axis=-1)

        loglike = mesh.shard_callback(
            make_loglike_device(host_like, True, False))
        x_host = np.random.default_rng(0).normal(
            size=(n, n_dim)).astype(np.float32)
        logl = mesh.gather(jax.jit(loglike)(
            mesh.shard_particles(x_host),
            mesh.shard_particles(np.ones(n, dtype=bool))))
        np.testing.assert_allclose(logl, -0.5 * np.sum(x_host**2, 1),
                                   atol=1e-5)
        local_rows = n // mesh.size
        assert max(seen) <= local_rows * n_local, (seen, local_rows)

        # 3. the real adaptive sweep program on sharded particles
        prior = Prior([Normal(0.0, 3.0) for _ in range(n_dim)])
        scaler = Reparameterize(n_dim, bounds=prior.bounds)

        def log_like(x):
            return -0.5 * jnp.sum(x**2, axis=-1)

        sweep = make_sweep(scaler=scaler, log_prior=prior.logpdf,
                           log_like=make_loglike_device(log_like, True, True),
                           n_dim=n_dim, n_steps=2, n_max=4, kind="tpcn",
                           preconditioned=False)
        u0 = x_host.copy()
        x0, ldj0 = scaler.inverse(u0)
        res = sweep(mesh.shard_particles(u0),
                    mesh.shard_particles(np.asarray(x0)),
                    mesh.shard_particles(np.asarray(ldj0)),
                    mesh.shard_particles(
                        np.asarray(log_like(jnp.asarray(x0)))),
                    mesh.shard_particles(np.asarray(prior.logpdf(x0))),
                    jnp.float32(0.5), jnp.float32(2.38 / np.sqrt(n_dim)),
                    fit_geometry_jax(jnp.asarray(u0)), jax.random.key(7))
        u_new = mesh.gather(res["u"])
        sweep_steps = int(res["steps"])
        assert np.isfinite(u_new).all() and sweep_steps >= 2
        checksum = float(np.sum(u_new.astype(np.float64)))

    # 4.-6. full Sampler.run() end-to-end over the global mesh
    from pocomc_tpu import Sampler

    d2 = 2
    pr = Prior([Normal(0.0, 2.0) for _ in range(d2)])
    n_active = 16 * mesh.size
    tiny = dict(n_effective=2 * n_active, n_active=n_active,
                flow="nsf3", train_config={"epochs": 5, "patience": 2},
                random_state=11, mesh=mesh, vectorize=True)

    def run_case(like, expect_device_loop, **run_kw):
        s = Sampler(pr, like, **tiny)
        assert s._use_device_loop() == expect_device_loop
        s.run(n_total=2 * n_active, n_evidence=n_active, progress=False,
              **run_kw)
        xs, w, _, _ = s.posterior()
        return float(s.logz) + float(np.sum(xs * w[:, None]))

    def like_traced(x):
        return -0.5 * jnp.sum(x**2, axis=-1) - d2 * 0.919

    run_seen: list[int] = []

    def like_blackbox(x):
        x = np.asarray(x)            # numpy body: not JAX-traceable
        run_seen.append(x.shape[0])
        return -0.5 * np.sum(x**2, axis=-1) - d2 * 0.919

    # Every host-side row count the sampler ships through
    # shard_particles (particles, pow2-bucketed training sets) divides a
    # pow2 mesh by design, so there the replication fallback must NEVER
    # engage inside a full run; on a non-pow2 mesh (e.g. 3 procs) the
    # HOST path's pow2 training buckets are indivisible and must hit it.
    # (The device loop keeps history/training resident on device and
    # never re-shards host arrays mid-run, so only the host path is a
    # fallback probe.) Both directions are asserted after the runs.
    pow2_mesh = (mesh.size & (mesh.size - 1)) == 0
    fb0 = mesh.replication_fallbacks

    cs_dev = cs_host = cs_res = 0.0
    if "dev" in want:
        cs_dev = run_case(like_traced, True)
        checksum += cs_dev
    if "host" in want:
        cs_host = run_case(like_blackbox, False)
        # the sweep fan-out hands each process only its local rows;
        # warmup/evidence evaluate replicated full batches everywhere
        assert min(run_seen) <= n_active // num_processes, run_seen
        checksum += cs_host
    fired = mesh.replication_fallbacks - fb0
    if pow2_mesh and ("dev" in want or "host" in want):
        assert fired == 0, f"unexpected replication fallback x{fired}"
    elif not pow2_mesh and "host" in want:
        assert fired > 0, "replication fallback never engaged"
    if "resume" in want:
        # 6. mid-run checkpoint under the mesh (rank-0-only atomic write)
        #    + a FRESH Sampler resuming from it. Exercises save_every +
        #    _sync_device_history + load_state_dict on a live multi-host
        #    mesh — the reference's checkpoint contract (ref
        #    sampler.py:1023-1049) at pod-scale layout.
        import glob
        import shutil
        from jax.experimental import multihost_utils

        ckdir = f"/tmp/pocomc_smoke_ck_{port}"
        if rank == 0 and os.path.isdir(ckdir):
            shutil.rmtree(ckdir)
        multihost_utils.sync_global_devices("ckdir-clean")
        s1 = Sampler(pr, like_traced, output_dir=ckdir, **tiny)
        s1.run(n_total=2 * n_active, n_evidence=0, progress=False,
               save_every=2)
        # every process must wait for rank 0 to finish the final rename
        multihost_utils.sync_global_devices("ckpt-written")
        # save_every also writes pmc_final.state — keep numbered states
        states = sorted(
            (p for p in glob.glob(f"{ckdir}/pmc_*.state")
             if p.rsplit("_", 1)[1].split(".")[0].isdigit()),
            key=lambda p: int(p.rsplit("_", 1)[1].split(".")[0]))
        assert states, f"no mid-run checkpoints written in {ckdir}"
        mid = states[0]          # earliest mid-run state: most to redo
        s2 = Sampler(pr, like_traced, output_dir=ckdir, **tiny)
        s2.run(n_total=2 * n_active, n_evidence=n_active, progress=False,
               resume_state_path=mid)
        assert s2.t > int(mid.rsplit("_", 1)[1].split(".")[0])
        xs, w, _, _ = s2.posterior()
        cs_res = float(s2.logz) + float(np.sum(xs * w[:, None]))
        assert np.isfinite(cs_res), cs_res
        checksum += cs_res
        multihost_utils.sync_global_devices("resume-done")
        if rank == 0:
            shutil.rmtree(ckdir, ignore_errors=True)

    print(f"MULTIHOST-OK rank={rank}/{count} devices={mesh.size} "
          f"local_batch_max={max(seen)} sweep_steps={sweep_steps} "
          f"run_logz_dev={cs_dev:.4f} run_logz_host={cs_host:.4f} "
          f"run_logz_resume={cs_res:.4f} "
          f"checksum={checksum:.6f}", flush=True)


def launch(num_processes: int = 2, n_local: int = 2,
           timeout: float = 420.0, cases: str = "all") -> list[str]:
    """Spawn the worker processes; return their MULTIHOST-OK lines.

    Raises on any worker failure or on checksum disagreement between
    processes (the SPMD contract: every host computes the identical
    global result).
    """
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # repo root on the path regardless of the caller's cwd
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "pocomc_tpu.parallel.smoke", "--worker",
             str(pid), str(num_processes), str(port), str(n_local), cases],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for pid in range(num_processes)
    ]
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outputs.append(out)
            if p.returncode != 0:
                raise RuntimeError(
                    f"multihost smoke worker failed "
                    f"(rc={p.returncode}):\n{out}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ok_lines = [ln for out in outputs for ln in out.splitlines()
                if ln.startswith("MULTIHOST-OK")]
    if len(ok_lines) != num_processes:
        raise RuntimeError(f"expected {num_processes} MULTIHOST-OK lines, "
                           f"got {len(ok_lines)}:\n" + "\n".join(outputs))
    checksums = {ln.rsplit("checksum=", 1)[1] for ln in ok_lines}
    if len(checksums) != 1:
        raise RuntimeError(f"processes disagree on the global sweep result: "
                           f"{sorted(checksums)}")
    return ok_lines


def main(argv):
    if argv and argv[0] == "--worker":
        pid, nproc, port, n_local = map(int, argv[1:5])
        cases = argv[5] if len(argv) > 5 else "all"
        run_worker(pid, nproc, port, n_local, cases)
        return
    nproc = int(argv[0]) if argv else 2
    n_local = int(argv[1]) if len(argv) > 1 else 2
    cases = argv[2] if len(argv) > 2 else "all"
    for line in launch(nproc, n_local, cases=cases):
        print(line)


if __name__ == "__main__":
    main(sys.argv[1:])
