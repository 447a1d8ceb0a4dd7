"""Mesh-sharded execution on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import pocomc_tpu as pc
from pocomc_tpu.parallel import ParticleMesh


def gaussian_loglike(x):
    return -0.5 * jnp.sum(x**2, axis=-1) - jnp.log(2 * jnp.pi)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return ParticleMesh(jax.devices()[:8])


def test_mesh_properties(mesh):
    assert mesh.size == 8
    assert mesh.pad_to_multiple(13) == 16
    arr = mesh.shard_particles(jnp.zeros((64, 3)))
    assert arr.sharding.spec == mesh.particle_spec


def test_n_active_divisibility(mesh):
    prior = pc.Prior([pc.Normal(0, 5), pc.Normal(0, 5)])
    with pytest.raises(ValueError):
        pc.Sampler(prior, gaussian_loglike, vectorize=True,
                   n_active=100, n_effective=200, mesh=mesh)


def test_sharded_run_matches_analytic(mesh):
    prior = pc.Prior([pc.Normal(0, 5), pc.Normal(0, 5)])
    s = pc.Sampler(prior, gaussian_loglike, vectorize=True, random_state=0,
                   n_effective=256, n_active=128, precondition=False,
                   mesh=mesh)
    s.run(n_total=512, n_evidence=0, progress=False)
    from scipy.stats import norm
    expect = 2 * norm.logpdf(0, 0, np.sqrt(26.0))
    logz, _ = s.evidence()
    assert abs(logz - expect) < 0.3


@pytest.mark.parametrize("kind", ["mala", "hmc"])
def test_sharded_gradient_kernels(mesh, kind):
    """The autodiff (vjp) target passes of the gradient kernels must
    shard over the particle mesh like the random-walk kernels do."""
    prior = pc.Prior([pc.Normal(0, 5), pc.Normal(0, 5)])
    s = pc.Sampler(prior, gaussian_loglike, vectorize=True, random_state=0,
                   n_effective=256, n_active=128, sample=kind, flow="nsf3",
                   n_leapfrog=2, mesh=mesh,
                   train_config={"epochs": 40, "patience": 5})
    s.run(n_total=512, n_evidence=512, progress=False)
    from scipy.stats import norm
    expect = 2 * norm.logpdf(0, 0, np.sqrt(26.0))
    assert abs(s.logz - expect) < 0.4


def test_dryrun_multichip_entry():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import __graft_entry__ as g
    g.dryrun_multichip(8)


def test_mpipool_requires_mpi():
    # mpi4py is not installed in this image; the class must degrade with a
    # clear ImportError instead of crashing at import time.
    try:
        import mpi4py  # noqa
        pytest.skip("mpi4py available; pool behavior exercised elsewhere")
    except ImportError:
        with pytest.raises(ImportError):
            pc.MPIPool()
