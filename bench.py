"""Benchmark lines for the sampler on one NVIDIA GPU.

    python bench.py

Prints one JSON line per metric. Every line names the device as JAX
reports it (platform, device_kind, device count) and the card's name
and power limit as nvidia-smi reports them. Without a GPU it exits
non-zero: a number from another device is never printed under these
metric names.

1. quickstart_wall_seconds_rosenbrock10_warm — end-to-end wall of the
   reference quickstart (10-D Rosenbrock, N(0,3) prior, reference
   defaults, n_total=4096, n_evidence=4096): median of 3 seeds after
   one un-timed run that compiles every program. The median logZ is
   gated against the exact quadrature value -21.4021 to +-0.35, so a
   statistically broken run cannot score. The reference executes the
   same inference in 150 s on a CPU (BASELINE.md quickstart row).
2. tpcn_particle_steps_per_sec_d50_nsfc12_n64k — a fixed-length t-pCN
   sweep at d=50 with the nsfc12 coupling flow at 65,536 particles: the
   compute-bound shape (one flow pass per direction and transform).
3. tpcn_particle_steps_per_sec_rosenbrock10_nsf6 — the same at the
   quickstart's own shape (d=10, nsf6, 4,096 particles), where the
   autoregressive inverse's d sequential steps bound the sweep.

Sweep timing: one sweep per timed call, ended by block_until_ready
(which on CUDA waits for the device), median over repetitions. A sweep
at these shapes takes milliseconds against tens of microseconds of
dispatch, so no chaining of sweeps inside one program is needed.

Roofline share: each sweep step runs one flow inverse, whose matmuls
are most of the step's arithmetic, and the sweep traces the flow under
matmul precision "float32" (FP32 SGEMM, no tensor-core TF32). So the
flow's matmul FLOPs, counted from its shapes (`flow_inverse_flops`),
times particle-steps over the sweep time, is divided by the FP32 peak
and named so. XLA's own cost analysis is no substitute on the GPU: it
counts a scan body once and cuBLAS calls not at all (it reported 0.24M
FLOPs per particle-step at d=50/nsfc12, against 6.8M from the shapes).
"""

import json
import subprocess
import sys
import time

import numpy as np

# Published dense peaks of NVIDIA H100 parts (NVIDIA H100 Tensor Core
# GPU data sheet; tensor-core rates without sparsity), keyed by a
# substring of jax's device_kind. A device not listed is an error.
PEAKS = {
    "H100 NVL": dict(bf16=835e12, tf32=418e12, fp32=60e12,
                     hbm_bytes_per_s=3.9e12),
    "H100 PCIe": dict(bf16=756e12, tf32=378e12, fp32=51e12,
                      hbm_bytes_per_s=2.0e12),
    "H100 SXM": dict(bf16=989e12, tf32=495e12, fp32=67e12,
                     hbm_bytes_per_s=3.35e12),
    "H100 80GB HBM3": dict(bf16=989e12, tf32=495e12, fp32=67e12,
                           hbm_bytes_per_s=3.35e12),  # the SXM part
}

QUICKSTART_TRUE_LOGZ = -21.4021  # 1-D quadrature of the factorized integrand
QUICKSTART_LOGZ_GATE = 0.35


def device_peaks(kind):
    """Published peaks of the device whose device_kind is `kind`."""
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    raise KeyError(f"no published peaks for device_kind {kind!r}; "
                   f"add the part to bench.PEAKS")


def gpu_name_and_power_limit():
    """`nvidia-smi --query-gpu=name,power.limit` as it prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu():
    """The device record every result carries; exits if no GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU found: JAX's default device is {dev.platform!r} "
                 f"({dev.device_kind}); this measurement runs on an "
                 f"NVIDIA GPU only")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "nvidia_smi": gpu_name_and_power_limit()}


def quickstart_problem():
    """The reference quickstart's likelihood and prior (reference
    docs/source/quickstart.ipynb)."""
    import jax.numpy as jnp
    import pocomc_tpu as pc

    def log_like(x):
        return -jnp.sum(10.0 * (x[..., ::2] ** 2 - x[..., 1::2]) ** 2
                        + (x[..., ::2] - 1.0) ** 2, axis=-1)

    return pc.Prior([pc.Normal(0.0, 3.0) for _ in range(10)]), log_like


def _rosenbrock_loglike():
    import jax.numpy as jnp

    def log_like(x):
        return -jnp.sum(100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2
                        + (1.0 - x[..., :-1]) ** 2, axis=-1)
    return log_like


def fixed_sweep(n_dim, flow_name, n_active, n_steps):
    """A fixed-length preconditioned t-pCN sweep on a Rosenbrock target.

    Returns (run, args, flow): `run(*args)` is the jitted sweep (plateau
    rule disabled, so it takes exactly `n_steps` steps) and returns its
    result dict; `args` are its inputs, built on the default device,
    with the PRNG key last."""
    import jax
    import jax.numpy as jnp
    from pocomc_tpu.mcmc import make_sweep, make_loglike_device
    from pocomc_tpu.models.flow import Flow
    from pocomc_tpu.models.geometry import fit_geometry_jax
    from pocomc_tpu.scaler import Reparameterize
    from pocomc_tpu.prior import Prior, Normal

    prior = Prior([Normal(0.0, 3.0) for _ in range(n_dim)])
    scaler = Reparameterize(n_dim, bounds=prior.bounds)
    flow = Flow(n_dim, flow_name, seed=0)
    log_like = _rosenbrock_loglike()
    loglike_dev = make_loglike_device(log_like, True, True)
    sweep = make_sweep(scaler=scaler, log_prior=prior.logpdf,
                       log_like=loglike_dev, n_dim=n_dim,
                       n_steps=10**6, n_max=n_steps, kind="tpcn",
                       preconditioned=True, flow_fwd=flow.kernel_fwd,
                       flow_inv=flow.kernel_inv)

    k1, k2 = jax.random.split(jax.random.key(0))
    u = jax.random.normal(k1, (n_active, n_dim), dtype=jnp.float32)
    x, logdetj = scaler.inverse(u)
    logl, logp = log_like(x), prior.logpdf(x)
    w = jnp.full((n_active,), 1.0 / n_active, dtype=jnp.float32)
    geom = fit_geometry_jax(u, weights=w, key=k2)
    beta, sigma0 = jnp.float32(0.7), jnp.float32(0.75)

    def run(u, x, logdetj, logl, logp, geom, flow_params, key):
        return sweep.raw(u, x, logdetj, logl, logp, beta, sigma0, geom,
                         key, flow_params=flow_params)

    args = (u, x, logdetj, logl, logp, geom, flow.params, jax.random.key(1))
    return jax.jit(run), args, flow


def flow_inverse_flops(flow):
    """Matmul FLOPs of one flow inverse for one particle, from the flow's
    shapes: the whitening layer plus, per transform, the 3-layer MADE
    (or coupling MLP) of width h and its output head. The
    autoregressive inverse runs the MADE once per dimension and keeps
    one dimension's head; a coupling inverse runs its MLP once on the
    conditioning half and emits the other half's heads."""
    d, h, p = flow.n_dim, flow.n_hidden, flow.n_params
    total = 2 * d * d
    if flow.kind == "nsfc":
        for mask in flow.coupling_masks:
            n_cond = int(mask.sum())
            total += 2 * (n_cond * h + 2 * h * h + h * (d - n_cond) * p)
    else:
        total += flow.n_transforms * d * 2 * (d * h + 2 * h * h + h * p)
    return total


def bench_quickstart(device):
    """Warm end-to-end wall on the reference quickstart."""
    import pocomc_tpu as pc
    prior, log_like = quickstart_problem()

    def one_run(seed):
        s = pc.Sampler(prior, log_like, vectorize=True, random_state=seed)
        t0 = time.perf_counter()
        s.run(n_total=4096, n_evidence=4096, progress=False)
        return time.perf_counter() - t0, s.logz, s.calls

    one_run(0)  # compiles every program (un-timed)
    walls, logzs, calls = zip(*(one_run(seed) for seed in (1, 2, 3)))
    wall = float(np.median(walls))
    logz = float(np.median(logzs))
    if not abs(logz - QUICKSTART_TRUE_LOGZ) < QUICKSTART_LOGZ_GATE:
        raise RuntimeError(f"quickstart logZ {logz:.3f} vs exact "
                           f"{QUICKSTART_TRUE_LOGZ}")
    ref_wall = 150.0
    out = {
        "metric": "quickstart_wall_seconds_rosenbrock10_warm",
        "value": wall,
        "unit": "seconds (median of 3 full runs; reference CPU: 150 s)",
        "vs_baseline": ref_wall / wall,
        "walls": list(walls),
        "logz": logz,
        "likelihood_calls_median": int(np.median(calls)),
        "reference_likelihood_calls": 51456,
        "device": device,
    }
    print(json.dumps(out), flush=True)
    return out


def bench_sweep(device, n_dim, flow_name, n_active, n_steps, n_rep, metric,
                baseline=None):
    """Fixed-length t-pCN sweep throughput at one shape."""
    import jax
    run, args, flow = fixed_sweep(n_dim, flow_name, n_active, n_steps)
    t0 = time.perf_counter()
    res = jax.block_until_ready(run(*args))
    compile_s = time.perf_counter() - t0
    if int(res["steps"]) != n_steps:
        raise RuntimeError(f"sweep ran {int(res['steps'])} steps, "
                           f"expected {n_steps}")

    dts = []
    for i in range(n_rep):
        key = jax.random.key(2 + i)
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args[:-1], key))
        dts.append(time.perf_counter() - t0)
    dt = float(np.median(dts))
    rate = n_active * n_steps / dt

    fpp = flow_inverse_flops(flow)
    fp32_peak = device_peaks(device["kind"])["fp32"]
    out = {
        "metric": metric,
        "value": rate,
        "unit": "particle-steps/sec",
        "sweep_seconds_median": dt,
        "sweep_seconds": dts,
        "first_call_seconds": compile_s,
        "flow_matmul_flops_per_particle_step": fpp,
        "flow_matmul_flops_share_of_fp32_peak": fpp * rate / fp32_peak,
        "device": device,
    }
    if baseline:
        out["vs_baseline"] = rate / baseline
    print(json.dumps(out), flush=True)
    return out


def main():
    from pocomc_tpu.utils.tools import enable_compile_cache
    device = require_gpu()
    enable_compile_cache()
    bench_quickstart(device)
    bench_sweep(device, n_dim=50, flow_name="nsfc12", n_active=65536,
                n_steps=4, n_rep=10,
                metric="tpcn_particle_steps_per_sec_d50_nsfc12_n64k")
    # reference CPU: 51,456 calls / 150 s = ~343 particle-steps/sec
    # through its kernel including flow transforms
    bench_sweep(device, n_dim=10, flow_name="nsf6", n_active=4096,
                n_steps=16, n_rep=20,
                metric="tpcn_particle_steps_per_sec_rosenbrock10_nsf6",
                baseline=343.0)


if __name__ == "__main__":
    main()
