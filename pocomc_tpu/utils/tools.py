"""Small host-side utilities: progress line, pickleable function wrapper
and the persistent compile cache.

Parity: reference pocomc/tools.py:189-260.
"""

from __future__ import annotations

import numbers
import os
import sys
import time
from pathlib import Path

# Fixed in-checkout cache location shared by every entry point (the
# package, bench.py, chip_smoke.py, __graft_entry__.py): a cache whose
# directory moves between runs never hits.
DEFAULT_COMPILE_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def _fmt(v):
    if isinstance(v, numbers.Integral):
        return str(int(v))
    if isinstance(v, numbers.Real):
        return f"{float(v):.3g}"
    return str(v)


class ProgressBar:
    """One self-overwriting stderr line: iteration count plus a
    persistent stats postfix (``Iter 12: beta=0.31, calls=4.1e+04``).

    Redraws are throttled to ``min_interval`` seconds, because the live
    sweep tap updates the stats once per MCMC step."""

    min_interval = 0.1

    def __init__(self, show: bool = True, initial: int = 0, stream=None):
        self.show = bool(show)
        self.n = int(initial)
        self.info = dict()
        self.stream = sys.stderr if stream is None else stream
        self._last_draw = -float("inf")
        self._width = 0

    def _draw(self, force=False):
        if not self.show:
            return
        now = time.monotonic()
        if not force and now - self._last_draw < self.min_interval:
            return
        self._last_draw = now
        stats = ", ".join(f"{k}={_fmt(v)}" for k, v in self.info.items())
        line = f"Iter {self.n}: {stats}" if stats else f"Iter {self.n}"
        pad = " " * max(self._width - len(line), 0)
        self._width = len(line)
        self.stream.write("\r" + line + pad)
        self.stream.flush()

    def update_stats(self, info):
        self.info = {**self.info, **info}
        self._draw()

    def update_iter(self):
        self.n += 1
        self._draw()

    def close(self):
        if self.show:
            self._draw(force=True)
            self.stream.write("\n")
            self.stream.flush()
            self.show = False


class FunctionWrapper:
    """Bind args/kwargs to a log-probability function, pickleably."""

    def __init__(self, f, args=None, kwargs=None):
        self.f = f
        self.args = [] if args is None else args
        self.kwargs = {} if kwargs is None else kwargs

    def __call__(self, x):
        return self.f(x, *self.args, **self.kwargs)


def enable_compile_cache():
    """Turn on XLA's persistent compilation cache.

    The framework's hot programs (adaptive sweep, flow training, fused
    SMC iteration) each take seconds to compile; the persistent cache
    turns every later process's compile into a disk read.

    The directory is ``JAX_COMPILATION_CACHE_DIR`` when that is set (or
    whatever ``jax.config.jax_compilation_cache_dir`` already names),
    and otherwise the fixed in-checkout ``DEFAULT_COMPILE_CACHE``. No
    other directory is ever configured. ``POCOMC_COMPILE_CACHE=off``
    (or ``0``/``false``/``no``) disables the helper.

    Called automatically by Sampler(compile_cache=True) (the default).
    Returns the cache directory in effect, or None when disabled.
    """
    import jax

    if os.environ.get("POCOMC_COMPILE_CACHE", "").lower() in (
            "0", "off", "false", "no"):
        return None
    path = (jax.config.jax_compilation_cache_dir
            or os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(DEFAULT_COMPILE_CACHE))
    try:
        os.makedirs(path, exist_ok=True)
        if jax.config.jax_compilation_cache_dir != path:
            jax.config.update("jax_compilation_cache_dir", path)
            jax.config.update("jax_persistent_cache_min_compile_time_secs",
                              0.5)
    except OSError:
        return None  # read-only location: run uncached
    return path
