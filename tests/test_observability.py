"""Cold-start + observability features (SURVEY.md section 5.1; VERDICT
round-1 item 9): persistent compile cache, jax.profiler hooks, live
per-step sweep statistics, and the documented custom-flow protocol.
"""

import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import pocomc_tpu as pc
from pocomc_tpu.utils.tools import enable_compile_cache


# ---------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------

@pytest.fixture
def no_cache_dir(monkeypatch):
    """A process with no compile-cache directory configured yet; the
    previous configuration is restored afterwards."""
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("POCOMC_COMPILE_CACHE", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_helper_sets_config(no_cache_dir):
    # unset environment: the one in-checkout directory, on every call
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    expect = os.path.join(repo, ".jax_cache")
    assert enable_compile_cache() == expect
    assert jax.config.jax_compilation_cache_dir == expect
    assert enable_compile_cache() == expect
    assert os.path.isdir(expect)


def test_compile_cache_uses_env_dir(no_cache_dir, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "xla"))
    assert enable_compile_cache() == str(tmp_path / "xla")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "xla")


def test_compile_cache_respects_configured_dir(no_cache_dir, tmp_path):
    jax.config.update("jax_compilation_cache_dir", str(tmp_path / "mine"))
    assert enable_compile_cache() == str(tmp_path / "mine")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "mine")


def test_compile_cache_env_off(monkeypatch):
    monkeypatch.setenv("POCOMC_COMPILE_CACHE", "off")
    assert enable_compile_cache() is None


# ---------------------------------------------------------------------
# progress line
# ---------------------------------------------------------------------

def test_progress_bar_line():
    import io
    from pocomc_tpu.utils.tools import ProgressBar
    out = io.StringIO()
    bar = ProgressBar(True, initial=3, stream=out)
    bar.min_interval = 0.0
    bar.update_stats(dict(beta=0.25, calls=1234, ESS=512.0))
    bar.update_iter()
    bar.update_stats(dict(beta=np.float64(1.0)))
    bar.close()
    text = out.getvalue()
    assert text.endswith("\n")
    assert text.split("\r")[-1].strip() == "Iter 4: beta=1, calls=1234, ESS=512"
    quiet = io.StringIO()
    bar = ProgressBar(False, stream=quiet)
    bar.update_stats(dict(beta=0.5))
    bar.update_iter()
    bar.close()
    assert quiet.getvalue() == ""


def test_progress_bar_throttles_redraws():
    import io
    from pocomc_tpu.utils.tools import ProgressBar
    out = io.StringIO()
    bar = ProgressBar(True, stream=out)
    bar.min_interval = 3600.0
    for i in range(100):
        bar.update_stats(dict(steps=i))
    assert out.getvalue().count("\r") == 1  # only the first draw
    bar.close()
    assert out.getvalue().split("\r")[-1] == "Iter 0: steps=99\n"


def test_main_path_runs_without_tqdm():
    import subprocess
    import sys
    code = ("import sys; sys.modules['tqdm'] = None\n"
            "import pocomc_tpu as pc, jax.numpy as jnp\n"
            "s = pc.Sampler(pc.Prior([pc.Normal(0, 3)] * 2),\n"
            "    lambda x: -0.5 * jnp.sum(x**2, axis=-1), vectorize=True,\n"
            "    random_state=0, n_effective=64, n_active=32,\n"
            "    precondition=False)\n"
            "s.run(n_total=64, n_evidence=0, progress=True)\n"
            "print('ok', 'tqdm' in sys.modules and sys.modules['tqdm'])\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok None")
    assert "Iter" in res.stderr


# ---------------------------------------------------------------------
# profiler hooks
# ---------------------------------------------------------------------

def test_profile_dir_writes_trace(tmp_path):
    prior = pc.Prior([pc.Normal(0, 3), pc.Normal(0, 3)])

    def loglike(x):
        return -0.5 * jnp.sum(x**2, axis=-1)

    s = pc.Sampler(prior, loglike, vectorize=True, random_state=0,
                   n_effective=128, n_active=64, precondition=False,
                   profile_dir=str(tmp_path / "trace"))
    s.run(n_total=128, n_evidence=0, progress=False)
    trace_files = [f for _, _, fs in os.walk(tmp_path / "trace") for f in fs]
    assert trace_files, "profiler produced no trace files"


# ---------------------------------------------------------------------
# live per-step sweep stats
# ---------------------------------------------------------------------

def test_live_stats_tap_sweep_level():
    """The fused sweep emits per-step packed stats through the module
    sink (reference shows calls/acc/steps live, mcmc.py:159-167)."""
    from pocomc_tpu.mcmc import make_sweep, make_loglike_device, set_live_sink
    from pocomc_tpu.models.geometry import fit_geometry_jax
    from pocomc_tpu.scaler import Reparameterize

    n_dim, n = 2, 64
    prior = pc.Prior([pc.Normal(0, 3) for _ in range(n_dim)])
    scaler = Reparameterize(n_dim, bounds=prior.bounds)

    def log_like(x):
        return -0.5 * jnp.sum(x**2, axis=-1)

    sweep = make_sweep(scaler=scaler, log_prior=prior.logpdf,
                       log_like=make_loglike_device(log_like, True, True),
                       n_dim=n_dim, n_steps=2, n_max=6, kind="tpcn",
                       preconditioned=False, live_stats=True)
    u = np.random.default_rng(0).normal(size=(n, n_dim)).astype(np.float32)
    x, ldj = scaler.inverse(u)
    emitted = []
    set_live_sink(lambda *a: emitted.append(a))
    try:
        res = sweep(u, x, ldj, log_like(x), prior.logpdf(x),
                    jnp.float32(0.5), jnp.float32(1.68),
                    fit_geometry_jax(jnp.asarray(u)), jax.random.key(0))
        steps = int(jax.device_get(res["steps"]))
    finally:
        set_live_sink(None)
    assert len(emitted) == steps
    # monotone step counter, final accept matches the sweep result
    assert [e[0] for e in emitted] == list(range(1, steps + 1))
    assert emitted[-1][3] == pytest.approx(float(res["accept"]), abs=1e-6)


def test_sampler_live_stats_blackbox_path():
    """Black-box numpy likelihood on a callback-capable backend: the
    Sampler enables the live tap and per-step pbar updates arrive."""
    from pocomc_tpu.utils.tools import ProgressBar

    prior = pc.Prior([pc.Normal(0, 3), pc.Normal(0, 3)])

    def loglike(x):  # numpy => not traceable => pure_callback path
        return -0.5 * np.sum(np.asarray(x)**2, axis=-1)

    s = pc.Sampler(prior, loglike, vectorize=True, random_state=0,
                   n_effective=128, n_active=64, precondition=False)
    assert not s.likelihood_traceable
    assert s._sweep_mode == "fused" and s._live_stats

    live_updates = []
    orig = ProgressBar.update_stats

    def spy(self, info):
        if set(info) == {"steps", "acc", "calls"}:
            live_updates.append(dict(info))
        return orig(self, info)

    ProgressBar.update_stats = spy
    try:
        s.run(n_total=128, n_evidence=0, progress=True)
    finally:
        ProgressBar.update_stats = orig
    # per-step feedback arrived from inside the fused sweeps: several
    # updates per sweep (warmup rows record steps=1 without a sweep, so
    # compare against the post-warmup mutation sweeps only)
    steps_per_iter = s.particles.get("steps")
    mutate_steps = int(sum(st for st in steps_per_iter if st > 1))
    assert len(live_updates) >= max(mutate_steps - 2, 2)
    assert max(u["steps"] for u in live_updates) >= 2


# ---------------------------------------------------------------------
# custom flow protocol (docs/flows.md "Custom flows")
# ---------------------------------------------------------------------

class AffineFlow:
    """Minimal protocol-complete preconditioner: learnable diagonal
    affine map. Host-path only (no _loss_fn/_sample/_log_prob), so the
    Sampler must transparently fall back from the device loop."""

    def __init__(self, n_dim):
        self.n_dim = n_dim
        self.params = dict(mu=jnp.zeros(n_dim), log_sigma=jnp.zeros(n_dim))
        self._config_key = ("affine-test", n_dim)

    # --- kernel contract: both directions report log|det du/dtheta| ---
    @staticmethod
    def kernel_fwd(params, u):
        theta = (u - params["mu"]) * jnp.exp(-params["log_sigma"])
        ladj = jnp.full(u.shape[0], jnp.sum(params["log_sigma"]))
        return theta, ladj

    @staticmethod
    def kernel_inv(params, theta):
        u = theta * jnp.exp(params["log_sigma"]) + params["mu"]
        ladj = jnp.full(theta.shape[0], jnp.sum(params["log_sigma"]))
        return u, ladj

    # --- host-facing surface ---
    def forward(self, u):
        theta, ladj = self.kernel_fwd(self.params, u)
        return theta, -ladj

    def sample(self, size, key=None):
        z = jax.random.normal(key, (size, self.n_dim))
        u = z * jnp.exp(self.params["log_sigma"]) + self.params["mu"]
        logq = (-0.5 * jnp.sum(z * z, axis=-1)
                - 0.5 * self.n_dim * np.log(2 * np.pi)
                - jnp.sum(self.params["log_sigma"]))
        return u, logq

    def fit(self, x, weights=None, **kwargs):
        w = np.ones(len(x)) if weights is None else np.asarray(weights)
        w = w / w.sum()
        mu = (w[:, None] * np.asarray(x)).sum(0)
        var = (w[:, None] * (np.asarray(x) - mu) ** 2).sum(0)
        self.params = dict(mu=jnp.asarray(mu, jnp.float32),
                           log_sigma=jnp.asarray(
                               0.5 * np.log(np.maximum(var, 1e-12)),
                               jnp.float32))
        return self


def _gauss2_loglike(x):
    return -0.5 * jnp.sum(x**2, axis=-1) - np.log(2 * np.pi)


def test_custom_flow_protocol(tmp_path):
    from scipy.stats import norm
    d = 2
    prior = pc.Prior([pc.Normal(0, 5) for _ in range(d)])
    loglike = _gauss2_loglike
    flow = AffineFlow(d)
    s = pc.Sampler(prior, loglike, vectorize=True, random_state=0,
                   n_effective=256, n_active=128, flow=flow,
                   precondition=True)
    assert not s._device_loop_ok  # protocol-minimal flow => host path
    s.run(n_total=512, n_evidence=1024, progress=False)
    truth = d * norm.logpdf(0, 0, np.sqrt(26))
    assert s.logz == pytest.approx(truth, abs=max(4 * s.logz_err, 0.3))

    # Sampler pickling round-trips the custom flow object
    blob = pickle.dumps(s)
    s2 = pickle.loads(blob)
    assert isinstance(s2.flow, AffineFlow)
    np.testing.assert_allclose(np.asarray(s2.flow.params["mu"]),
                               np.asarray(s.flow.params["mu"]))
    x, w, _, _ = s2.posterior()
    assert np.isfinite(x).all()
