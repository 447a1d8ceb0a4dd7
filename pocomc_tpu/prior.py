"""Priors.

`Prior` is a container of independent 1-D distributions exposing the same
duck-typed protocol the reference sampler relies on (logpdf / rvs / bounds /
dim — /root/reference/pocomc/prior.py:70-171, consumed at sampler.py:204-222).

Device-side twist: the prior's logpdf is evaluated INSIDE the jitted MCMC
sweep on every proposal, so it must be XLA-traceable. We therefore ship a
set of JAX-native 1-D distributions and automatically convert common
`scipy.stats` frozen distributions into them — user code written against
the reference (`Prior([scipy.stats.norm(0, 1), ...])`) ports unchanged and
still compiles to a single fused kernel. Anything unconvertible falls back
to a host callback (still correct, just slower).
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy import stats as jstats


class BaseDist:
    """JAX-native 1-D distribution protocol: logpdf / sample / support."""

    def logpdf(self, x):
        raise NotImplementedError

    def sample(self, key, size):
        raise NotImplementedError

    def support(self):
        raise NotImplementedError

    # scipy-compatible host sampling used by Prior.rvs
    def rvs(self, size=1, random_state=None):
        seed = np.random.default_rng(random_state).integers(0, 2**31 - 1)
        return np.asarray(jax.device_get(self.sample(jax.random.key(int(seed)), size)))


class Normal(BaseDist):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = float(loc), float(scale)

    def logpdf(self, x):
        return jstats.norm.logpdf(x, self.loc, self.scale)

    def sample(self, key, size):
        return self.loc + self.scale * jax.random.normal(key, (size,))

    def support(self):
        return (-np.inf, np.inf)


class Uniform(BaseDist):
    def __init__(self, low=0.0, high=1.0):
        self.low, self.high = float(low), float(high)

    def logpdf(self, x):
        inside = (x >= self.low) & (x <= self.high)
        return jnp.where(inside, -jnp.log(self.high - self.low), -jnp.inf)

    def sample(self, key, size):
        return jax.random.uniform(key, (size,), minval=self.low, maxval=self.high)

    def support(self):
        return (self.low, self.high)


class LogUniform(BaseDist):
    def __init__(self, low, high):
        self.low, self.high = float(low), float(high)
        self._norm = math.log(math.log(high / low))

    def logpdf(self, x):
        inside = (x >= self.low) & (x <= self.high)
        return jnp.where(inside, -jnp.log(x) - self._norm, -jnp.inf)

    def sample(self, key, size):
        u = jax.random.uniform(key, (size,))
        return self.low * jnp.exp(u * math.log(self.high / self.low))

    def support(self):
        return (self.low, self.high)


class TruncatedNormal(BaseDist):
    """scipy.truncnorm parameterization: a, b in standard-normal units."""

    def __init__(self, a, b, loc=0.0, scale=1.0):
        self.a, self.b = float(a), float(b)
        self.loc, self.scale = float(loc), float(scale)
        cdf = lambda z: 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
        self._log_mass = math.log(max(cdf(self.b) - cdf(self.a), 1e-300))

    def logpdf(self, x):
        z = (x - self.loc) / self.scale
        inside = (z >= self.a) & (z <= self.b)
        lp = jstats.norm.logpdf(z) - math.log(self.scale) - self._log_mass
        return jnp.where(inside, lp, -jnp.inf)

    def sample(self, key, size):
        return self.loc + self.scale * jax.random.truncated_normal(key, self.a, self.b, (size,))

    def support(self):
        return (self.loc + self.a * self.scale, self.loc + self.b * self.scale)


class LogNormal(BaseDist):
    """scipy.lognorm(s, loc=0, scale): log(x) ~ N(log(scale), s^2)."""

    def __init__(self, s, loc=0.0, scale=1.0):
        self.s, self.loc, self.scale = float(s), float(loc), float(scale)

    def logpdf(self, x):
        y = (x - self.loc) / self.scale
        safe = jnp.maximum(y, 1e-300)
        lp = (-jnp.log(safe * self.s) - 0.5 * math.log(2 * math.pi)
              - 0.5 * (jnp.log(safe) / self.s) ** 2 - math.log(self.scale))
        return jnp.where(y > 0, lp, -jnp.inf)

    def sample(self, key, size):
        return self.loc + self.scale * jnp.exp(self.s * jax.random.normal(key, (size,)))

    def support(self):
        return (self.loc, np.inf)


class Beta(BaseDist):
    def __init__(self, a, b, loc=0.0, scale=1.0):
        self.a, self.b = float(a), float(b)
        self.loc, self.scale = float(loc), float(scale)

    def logpdf(self, x):
        y = (x - self.loc) / self.scale
        return jstats.beta.logpdf(y, self.a, self.b) - math.log(self.scale)

    def sample(self, key, size):
        return self.loc + self.scale * jax.random.beta(key, self.a, self.b, (size,))

    def support(self):
        return (self.loc, self.loc + self.scale)


class Gamma(BaseDist):
    def __init__(self, a, loc=0.0, scale=1.0):
        self.a, self.loc, self.scale = float(a), float(loc), float(scale)

    def logpdf(self, x):
        y = (x - self.loc) / self.scale
        return jstats.gamma.logpdf(y, self.a) - math.log(self.scale)

    def sample(self, key, size):
        return self.loc + self.scale * jax.random.gamma(key, self.a, (size,))

    def support(self):
        return (self.loc, np.inf)


class Exponential(BaseDist):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = float(loc), float(scale)

    def logpdf(self, x):
        y = (x - self.loc) / self.scale
        return jnp.where(y >= 0, -y - math.log(self.scale), -jnp.inf)

    def sample(self, key, size):
        return self.loc + self.scale * jax.random.exponential(key, (size,))

    def support(self):
        return (self.loc, np.inf)


class HalfNormal(BaseDist):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = float(loc), float(scale)

    def logpdf(self, x):
        y = (x - self.loc) / self.scale
        lp = 0.5 * math.log(2.0 / math.pi) - 0.5 * y * y - math.log(self.scale)
        return jnp.where(y >= 0, lp, -jnp.inf)

    def sample(self, key, size):
        return self.loc + self.scale * jnp.abs(jax.random.normal(key, (size,)))

    def support(self):
        return (self.loc, np.inf)


class Cauchy(BaseDist):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = float(loc), float(scale)

    def logpdf(self, x):
        return jstats.cauchy.logpdf(x, self.loc, self.scale)

    def sample(self, key, size):
        return self.loc + self.scale * jax.random.cauchy(key, (size,))

    def support(self):
        return (-np.inf, np.inf)


class StudentT(BaseDist):
    def __init__(self, df, loc=0.0, scale=1.0):
        self.df, self.loc, self.scale = float(df), float(loc), float(scale)

    def logpdf(self, x):
        return jstats.t.logpdf(x, self.df, self.loc, self.scale)

    def sample(self, key, size):
        return self.loc + self.scale * jax.random.t(key, self.df, (size,))

    def support(self):
        return (-np.inf, np.inf)


class Laplace(BaseDist):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = float(loc), float(scale)

    def logpdf(self, x):
        return jstats.laplace.logpdf(x, self.loc, self.scale)

    def sample(self, key, size):
        return self.loc + self.scale * jax.random.laplace(key, (size,))

    def support(self):
        return (-np.inf, np.inf)


# ---------------------------------------------------------------------------
# scipy.stats frozen distribution conversion
# ---------------------------------------------------------------------------

def _convert_scipy(dist):
    """Convert a scipy.stats frozen distribution to a JAX-native one.

    Returns None if the distribution family is not recognized.
    """
    name = getattr(getattr(dist, "dist", None), "name", None)
    if name is None:
        return None
    args = tuple(dist.args)
    kwds = dict(dist.kwds)

    def get(i, keyname, default):
        if keyname in kwds:
            return kwds[keyname]
        if len(args) > i:
            return args[i]
        return default

    try:
        if name == "norm":
            return Normal(get(0, "loc", 0.0), get(1, "scale", 1.0))
        if name == "uniform":
            loc, scale = get(0, "loc", 0.0), get(1, "scale", 1.0)
            return Uniform(loc, loc + scale)
        if name == "truncnorm":
            return TruncatedNormal(get(0, "a", -np.inf), get(1, "b", np.inf),
                                   get(2, "loc", 0.0), get(3, "scale", 1.0))
        if name == "lognorm":
            return LogNormal(get(0, "s", 1.0), get(1, "loc", 0.0), get(2, "scale", 1.0))
        if name == "beta":
            return Beta(get(0, "a", 1.0), get(1, "b", 1.0),
                        get(2, "loc", 0.0), get(3, "scale", 1.0))
        if name == "gamma":
            return Gamma(get(0, "a", 1.0), get(1, "loc", 0.0), get(2, "scale", 1.0))
        if name == "expon":
            return Exponential(get(0, "loc", 0.0), get(1, "scale", 1.0))
        if name == "halfnorm":
            return HalfNormal(get(0, "loc", 0.0), get(1, "scale", 1.0))
        if name == "cauchy":
            return Cauchy(get(0, "loc", 0.0), get(1, "scale", 1.0))
        if name == "t":
            return StudentT(get(0, "df", 1.0), get(1, "loc", 0.0), get(2, "scale", 1.0))
        if name == "laplace":
            return Laplace(get(0, "loc", 0.0), get(1, "scale", 1.0))
        if name == "loguniform":
            return LogUniform(get(0, "a", 1.0), get(1, "b", 10.0))
    except Exception:
        return None
    return None


class Prior:
    """Product of independent 1-D distributions.

    Accepts JAX-native distributions from this module, scipy.stats frozen
    distributions (converted automatically when recognized), or any object
    with logpdf/rvs/support. `logpdf` is XLA-traceable whenever every
    component is JAX-native or convertible.
    """

    def __init__(self, dists):
        self.dists = list(dists)
        self._jax_dists = []
        self.traceable = True
        for d in self.dists:
            if isinstance(d, BaseDist):
                self._jax_dists.append(d)
            else:
                conv = _convert_scipy(d)
                if conv is not None:
                    self._jax_dists.append(conv)
                else:
                    self._jax_dists.append(None)
                    self.traceable = False

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_rvs_jit", None)  # jitted sampler, rebuilt lazily
        return state

    @property
    def dim(self):
        return len(self.dists)

    @property
    def bounds(self):
        out = []
        for d, jd in zip(self.dists, self._jax_dists):
            if jd is not None:
                out.append(jd.support())
            else:
                out.append(tuple(d.support()))
        return np.array(out, dtype=np.float64)

    def logpdf(self, x):
        """Log prior density; traceable if all components are JAX-native."""
        if self.traceable:
            x = jnp.asarray(x)
            lp = jnp.zeros(x.shape[0], dtype=x.dtype)
            for i, jd in enumerate(self._jax_dists):
                lp = lp + jd.logpdf(x[:, i])
            return lp
        x = np.asarray(x)
        lp = np.zeros(len(x))
        for i, d in enumerate(self.dists):
            lp += d.logpdf(x[:, i])
        return lp

    def _sample_jax(self, seed, size):
        """All JAX-native columns in ONE jitted program (per-dimension
        eager sampling would dispatch one device op per column)."""
        fn = getattr(self, "_rvs_jit", None)
        if fn is None:
            jds = self._jax_dists

            def sample_all(seed, size):
                keys = jax.random.split(jax.random.key(seed), len(jds))
                return jnp.stack(
                    [jd.sample(keys[i], size) if jd is not None
                     else jnp.zeros(size)
                     for i, jd in enumerate(jds)], axis=1)

            fn = self._rvs_jit = jax.jit(sample_all,
                                         static_argnames=("size",))
        return np.asarray(jax.device_get(fn(np.uint32(seed), size)),
                          dtype=np.float64)

    def rvs(self, size=1, random_state=None):
        """Draw samples (host-side).

        Duck-typed (unconvertible) columns are seeded too: the reference
        makes custom priors reproducible by seeding np.random globally
        (sampler.py:195-197); here each fallback column first gets the
        seed through `rvs(random_state=...)` and, if the signature
        rejects it, draws under a temporarily seeded global np.random
        state so seed-less scipy-style `rvs` implementations still
        repeat under a fixed `random_state`.
        """
        rng = np.random.default_rng(random_state)
        seed = int(rng.integers(0, 2**31 - 1))
        out = self._sample_jax(seed, int(size))
        for i, (d, jd) in enumerate(zip(self.dists, self._jax_dists)):
            if jd is None:
                col_seed = int(rng.integers(0, 2**31 - 1))
                try:
                    col = d.rvs(size=size, random_state=col_seed)
                except TypeError:
                    saved = np.random.get_state()
                    try:
                        np.random.seed(col_seed)
                        col = d.rvs(size=size)
                    finally:
                        np.random.set_state(saved)
                out[:, i] = np.asarray(col)
        return out
