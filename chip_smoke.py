"""Bring-up check: the sampler's main path, end to end, on NVIDIA GPUs.

    python chip_smoke.py          # phases 1-5 on one GPU
    python chip_smoke.py --four   # phase 6 alone: the particle mesh on 4 GPUs

Every phase runs in this one process, the only one that opens the cards.
Phases, through the public API (`import pocomc_tpu as pc`):

1. device: a GPU must be JAX's default device, else the script exits
   non-zero before any phase runs. Prints the card's name and power
   limit (nvidia-smi), device_kind, the JAX version and the compile
   cache in effect.
2. quickstart at reference defaults (n_total=n_evidence=4096): cold
   and warm wall, likelihood calls, logZ against the exact -21.4021.
3. gauss50 at full size (benchmarks/baseline_configs.py): wall, calls,
   logZ against the analytic value, evidence k-hat, peak device memory.
4. host-callback paths: a numpy likelihood inside the fused sweep
   (jax.pure_callback), the blobs example (stepped sweep), and a
   save_every / resume_state_path round trip; each against its exact
   logZ.
5. the same program on the card and on the host CPU: flow density,
   both flow directions and their round trip (d=50, nsf12 and nsfc12),
   one fixed-length t-pCN sweep; which matmuls outside the "float32"
   precision context run in TF32; the 65,536-particle sweep compiled
   and run on the card alone, with its memory analysis.
6. (--four only) gauss50 on a 4-card ParticleMesh, and a numpy
   likelihood fanned out through ParticleMesh.shard_callback; the
   history's sharding and every card's peak memory show all four work.

A failed check raises, so the exit code is non-zero. Only when every
phase passed is the last line of standard output
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

QUICKSTART_LOGZ = -21.4021
# bench.py's gate: seed-to-seed flow-IS spread is ~0.1 nat
QUICKSTART_BAR = 0.35
# gauss50's 8-seed median error was -0.013 (IQR +-0.03)
GAUSS50_BAR = 0.25
# d=4/5 Gaussians at reference defaults: seed-to-seed spread ~0.05 nat
SMALL_BAR = 0.25


def say(*args):
    print(*args, flush=True)


def require(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def peak_bytes(dev):
    """peak_bytes_in_use of one device, or None where the backend keeps
    no allocator statistics (the CPU)."""
    stats = dev.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _timed_run(sampler, **run_kw):
    t0 = time.perf_counter()
    sampler.run(progress=False, **run_kw)
    return time.perf_counter() - t0


# ---------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------

def phase_device():
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU found (JAX's default device is "
                 f"{devices[0].platform!r}); this check runs on an NVIDIA "
                 f"GPU only")
    from bench import gpu_name_and_power_limit
    from pocomc_tpu.utils.tools import enable_compile_cache
    say(f"nvidia-smi: {gpu_name_and_power_limit()}")
    say(f"device_kind {devices[0].device_kind!r}, {len(devices)} device(s), "
        f"jax {jax.__version__}")
    say(f"compile cache: {enable_compile_cache()}")
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


# ---------------------------------------------------------------------
# 2. quickstart
# ---------------------------------------------------------------------

def phase_quickstart(n_total=4096, n_evidence=4096, bar=QUICKSTART_BAR,
                     **sampler_kw):
    import pocomc_tpu as pc
    from bench import quickstart_problem
    prior, log_like = quickstart_problem()
    for seed, label in ((0, "cold (compiles)"), (1, "warm")):
        s = pc.Sampler(prior, log_like, vectorize=True, random_state=seed,
                       **sampler_kw)
        wall = _timed_run(s, n_total=n_total, n_evidence=n_evidence)
        err = s.logz - QUICKSTART_LOGZ
        say(f"quickstart {label}: wall {wall:.3f} s, calls {s.calls}, "
            f"logZ {s.logz:.4f} (exact {QUICKSTART_LOGZ}, err {err:+.4f}, "
            f"bar {bar})")
        require(abs(err) < bar, f"quickstart logZ error {err:+.4f}")
    say(f"live-stats tap compiled into the device-loop sweep: "
        f"{bool(s._live_stats and s._use_device_loop())}")
    return s


# ---------------------------------------------------------------------
# 3. gauss50
# ---------------------------------------------------------------------

def phase_gauss50(d=50, n_total=4096, n_evidence=4096, bar=GAUSS50_BAR,
                  mesh=None, label="gauss50", **sampler_kw):
    import jax
    import pocomc_tpu as pc
    from benchmarks.baseline_configs import gauss50_problem
    prior, loglike, expect, sizes, _, _ = gauss50_problem(d)
    sizes.update(sampler_kw)
    s = pc.Sampler(prior, loglike, vectorize=True, random_state=0,
                   mesh=mesh, **sizes)
    wall = _timed_run(s, n_total=n_total, n_evidence=n_evidence)
    err = s.logz - expect
    devices = jax.devices() if mesh is None else mesh.devices
    say(f"{label}: wall {wall:.3f} s, calls {s.calls}, logZ {s.logz:.4f} "
        f"(analytic {expect:.4f}, err {err:+.4f}, bar {bar}), "
        f"evidence_khat {s.evidence_khat:.3f}, peak_bytes_in_use "
        f"{[peak_bytes(dv) for dv in devices[:4]]}")
    require(np.isfinite(s.logz) and abs(err) < bar,
            f"{label} logZ error {err:+.4f}")
    return s


# ---------------------------------------------------------------------
# 4. host-callback paths
# ---------------------------------------------------------------------

def _gauss4_numpy(x):
    """Normalized 4-D unit Gaussian, plain numpy on one point: JAX cannot
    trace it, so it runs through jax.pure_callback."""
    x = np.asarray(x, dtype=np.float64)
    return float(-0.5 * np.dot(x, x) - 2.0 * np.log(2.0 * np.pi))


def phase_numpy_callback(n_total=4096, n_evidence=4096, bar=SMALL_BAR,
                         mesh=None, label="numpy likelihood", **sampler_kw):
    import pocomc_tpu as pc
    from scipy.stats import norm
    prior = pc.Prior([pc.Normal(0, 5) for _ in range(4)])
    s = pc.Sampler(prior, _gauss4_numpy, vectorize=False, random_state=0,
                   mesh=mesh, **sampler_kw)
    require(not s.likelihood_traceable and s._sweep_mode == "fused",
            f"{label}: expected the fused sweep with a host callback, got "
            f"traceable={s.likelihood_traceable} mode={s._sweep_mode}")
    wall = _timed_run(s, n_total=n_total, n_evidence=n_evidence)
    expect = 4 * norm.logpdf(0, 0, np.sqrt(26))
    err = s.logz - expect
    say(f"{label} (pure_callback in the fused sweep): wall {wall:.3f} s, "
        f"calls {s.calls}, logZ {s.logz:.4f} (exact {expect:.4f}, err "
        f"{err:+.4f}, bar {bar})")
    require(abs(err) < bar, f"{label} logZ error {err:+.4f}")
    return s


def phase_blobs(n_total=4096, n_evidence=4096, bar=SMALL_BAR, **sampler_kw):
    import pocomc_tpu as pc
    from examples import blobs as ex
    s = pc.Sampler(ex.prior, ex.log_likelihood,
                   blobs_dtype=[("median", float), ("n_positive", int)],
                   random_state=0, **sampler_kw)
    wall = _timed_run(s, n_total=n_total, n_evidence=n_evidence)
    require(s._sweep_mode == "stepped", f"blobs ran {s._sweep_mode}")
    x, _, _, _, blobs = s.posterior(return_blobs=True)
    require(np.allclose(blobs["median"], np.median(x, axis=1))
            and np.array_equal(blobs["n_positive"], np.sum(x > 0, axis=1)),
            "blobs do not match their samples")
    # exp(-x.x/2) under N(0, 5^2) in 5-D: logZ = -2.5 log 26
    expect = -2.5 * np.log(26.0)
    err = s.logz - expect
    say(f"blobs example (stepped sweep): wall {wall:.3f} s, calls "
        f"{s.calls}, logZ {s.logz:.4f} (exact {expect:.4f}, err "
        f"{err:+.4f}, bar {bar}), blobs match samples")
    require(abs(err) < bar, f"blobs logZ error {err:+.4f}")
    return s


def phase_checkpoint(n_total=4096, n_evidence=4096, bar=SMALL_BAR,
                     **sampler_kw):
    import pocomc_tpu as pc
    from examples import checkpoint as ex
    expect = -2.0 * np.log(26.0)  # exp(-x.x/2) under N(0, 5^2) in 4-D
    with tempfile.TemporaryDirectory() as tmp:
        s1 = pc.Sampler(ex.prior, ex.log_likelihood, vectorize=True,
                        random_state=0, output_dir=tmp, output_label="smoke",
                        **sampler_kw)
        _timed_run(s1, n_total=n_total, n_evidence=n_evidence, save_every=2)
        saved = sorted(f for f in os.listdir(tmp) if f.endswith(".state"))
        mid = [f for f in saved if not f.endswith("_final.state")]
        require(mid, f"no intermediate state written: {saved}")
        path = os.path.join(tmp, mid[len(mid) // 2])
        s2 = pc.Sampler(ex.prior, ex.log_likelihood, vectorize=True,
                        random_state=1, **sampler_kw)
        wall = _timed_run(s2, n_total=n_total, n_evidence=n_evidence,
                          resume_state_path=path)
    err1, err2 = s1.logz - expect, s2.logz - expect
    say(f"checkpoint: {len(saved)} states written; resumed "
        f"{os.path.basename(path)} to t={s2.t} in {wall:.3f} s, calls "
        f"{s2.calls}; logZ first {s1.logz:.4f} (err {err1:+.4f}), resumed "
        f"{s2.logz:.4f} (err {err2:+.4f}), exact {expect:.4f}, bar {bar}")
    require(abs(err1) < bar and abs(err2) < bar,
            f"checkpoint logZ errors {err1:+.4f} / {err2:+.4f}")
    return s2


# ---------------------------------------------------------------------
# 5. the same program on the card and on the host
# ---------------------------------------------------------------------

def scaled_dev(a, b):
    """max |a - b| over max(1, max |b|): absolute near zero, relative for
    large outputs such as log-densities."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


def tree_dev(a, b):
    import jax
    return max(scaled_dev(x, y) for x, y in
               zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


def _on(dev, fn, *args):
    import jax
    return jax.device_get(fn(*jax.device_put(args, dev)))


# f32 arithmetic in another summation order (cuBLAS against Eigen, GPU
# reductions against sequential ones), carried through 12 stacked
# transforms: a few hundred f32 roundings (eps 6e-8) of O(1) values. A
# matmul that ran in TF32 (10-bit mantissa, eps 5e-4) would show ~1e-3.
FLOW_TOL = 1e-4


def phase_compare(card, host, d=50, flows=("nsf12", "nsfc12"), n=4096,
                  sweep_flow="nsfc12", sweep_n=4096, big_n=65536):
    import jax
    from bench import fixed_sweep
    from pocomc_tpu.mcmc import _student_quadform
    from pocomc_tpu.models.flow import Flow, fit_pre_jax
    from pocomc_tpu.models.geometry import fit_geometry_jax

    rng = np.random.default_rng(0)
    failures = []

    def report(name, dev, tol, why):
        ok = dev <= tol
        say(f"  {name}: max deviation {dev:.3e}, tolerance {tol:.0e} "
            f"({why}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)

    say(f"card {card.device_kind!r} against host {host.device_kind!r}:")
    x = rng.normal(size=(n, d)).astype(np.float32)
    for name in flows:
        flow = Flow(d, name, seed=0)
        # zero-init output layers make a fresh flow the identity map:
        # perturb every weight of the transform stack so each transform
        # does real work (it moves points by ~0.5 at d=50). The
        # whitening layer stays an exact inverse pair. Larger noise
        # (0.01) drives 2% of nsfc12 outputs onto the spline bound +-5,
        # where the identity tails make the map non-invertible in f32.
        params = dict(flow.params, stack=jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.003 * rng.normal(
                size=np.shape(a)).astype(np.float32), flow.params["stack"]))
        fns = {
            "_log_prob": lambda p, v: flow._log_prob(p, v),
            "kernel_fwd": lambda p, v: flow.kernel_fwd(p, v),
            "kernel_inv": lambda p, v: flow.kernel_inv(p, v),
            "round trip": lambda p, v: flow.kernel_inv(
                p, flow.kernel_fwd(p, v)[0]),
        }
        for fname, fn in fns.items():
            fn = jax.jit(fn)
            a, b = _on(card, fn, params, x), _on(host, fn, params, x)
            report(f"{name} {fname}", tree_dev(a, b), FLOW_TOL,
                   "f32 rounding in another summation order")
            if fname == "round trip":
                report(f"{name} round trip recovers its input on the card",
                       scaled_dev(a[0], x), FLOW_TOL,
                       "f32 rounding of forward then inverse")

    # --- matmuls outside the "float32" precision context -------------
    cov = np.diag(np.logspace(0, 3, d))
    theta = (rng.normal(size=(n, d)) @ np.sqrt(cov)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    inv_cov = np.linalg.inv(cov).astype(np.float32)
    diff = theta[: n // 4] - theta[n // 4: n // 2]
    outside = {
        "geometry + Student-t fit (fit_geometry_jax)":
            (lambda t, v: fit_geometry_jax(t, v, jax.random.key(0)),
             (theta, w)),
        "whitening fit (fit_pre_jax)": (jax.jit(fit_pre_jax), (theta, w)),
        "t-pCN quadratic form (mcmc._student_quadform)":
            (jax.jit(_student_quadform), (diff, inv_cov)),
    }
    say("  matmuls outside the flow/likelihood context (card at default "
        "precision / card at 'highest', each against the host):")
    for name, (fn, args) in outside.items():
        ref = _on(host, fn, *args)
        dev_default = tree_dev(_on(card, fn, *args), ref)
        with jax.default_matmul_precision("highest"):
            dev_highest = tree_dev(_on(card, fn, *args), ref)
        tf32 = dev_default > 10 * max(dev_highest, 1e-6)
        say(f"    {name}: {dev_default:.3e} / {dev_highest:.3e} -> "
            f"{'runs in TF32' if tf32 else 'full f32'}")

    # --- one fixed-length t-pCN sweep --------------------------------
    run, args, _ = fixed_sweep(d, sweep_flow, sweep_n, 4)
    a, b = _on(card, run, *args), _on(host, run, *args)
    require(int(a["steps"]) == int(b["steps"]) == 4, "sweep step count")
    rows = np.max(np.abs(np.asarray(a["u"]) - np.asarray(b["u"])), axis=1)
    flipped = rows > 1e-2
    say(f"  t-pCN sweep d={d}/{sweep_flow}/{sweep_n}: {int(flipped.sum())} of "
        f"{sweep_n} particles took another accept/reject decision")
    report("t-pCN sweep, share of particles that diverged",
           float(flipped.mean()), 1e-2,
           "an accept/reject is a threshold: a rounding-level difference "
           "flips the particles whose log-ratio lies that close to their "
           "uniform draw")
    keep = ~flipped
    report("t-pCN sweep, the others (u, logl)",
           max(scaled_dev(np.asarray(a["u"])[keep], np.asarray(b["u"])[keep]),
               scaled_dev(np.asarray(a["logl"])[keep],
                          np.asarray(b["logl"])[keep])), 1e-3,
           "f32 rounding through 4 steps, the t-pCN quadratic form in "
           "TF32 on the card (above), and a sigma adapted from an "
           "acceptance mean that the flipped particles move")

    run, args, _ = fixed_sweep(d, sweep_flow, big_n, 4)
    compiled = run.lower(*args).compile()
    say(f"  t-pCN sweep d={d}/{sweep_flow}/{big_n} on the card: "
        f"{compiled.memory_analysis()}")
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    say(f"  ran in {time.perf_counter() - t0:.4f} s (first execution)")
    require(int(out["steps"]) == 4
            and bool(np.all(np.isfinite(np.asarray(out["logl"])))),
            f"{big_n}-particle sweep")
    require(not failures, f"card against host: {failures}")


# ---------------------------------------------------------------------
# 6. four cards
# ---------------------------------------------------------------------

def phase_mesh(devices, gauss_kw=None, callback_kw=None):
    """gauss50 with its particles sharded over `devices`, then a numpy
    likelihood fanned out per device through shard_callback. Each logZ
    is compared with its exact value: SMC trajectories are chaotic, so
    two runs on different meshes are not compared with each other."""
    import jax
    from pocomc_tpu.parallel.mesh import ParticleMesh
    mesh = ParticleMesh(devices)
    s = phase_gauss50(mesh=mesh, label=f"gauss50 on {len(devices)} cards",
                      **(gauss_kw or {}))
    sets = {len(leaf.sharding.device_set)
            for leaf in jax.tree_util.tree_leaves(s._hist_dev)
            if leaf.ndim >= 2}
    say(f"  device history sharded over {sorted(sets)} device(s)")
    require(sets == {len(devices)}, f"history sharding {sets}")
    phase_numpy_callback(mesh=mesh, label=f"numpy likelihood through "
                         f"shard_callback on {len(devices)} cards",
                         **(callback_kw or {}))
    peaks = [peak_bytes(dv) for dv in devices]
    say(f"peak_bytes_in_use per card: {peaks}; mesh replication_fallbacks "
        f"{mesh.replication_fallbacks}")
    if devices[0].platform == "gpu":
        require(all(peaks), f"a card stayed idle: {peaks}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the particle-mesh phase on 4 GPUs")
    args = ap.parse_args(argv)
    device = phase_device()
    import jax
    if args.four:
        require(len(jax.devices()) >= 4,
                f"--four needs 4 GPUs, found {len(jax.devices())}")
        phase_mesh(jax.devices()[:4])
        device["count"] = 4
    else:
        phase_quickstart()
        phase_gauss50()
        phase_numpy_callback()
        phase_blobs()
        phase_checkpoint()
        phase_compare(jax.devices()[0], jax.devices("cpu")[0])
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
