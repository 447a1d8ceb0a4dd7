"""Multi-host execution smoke tests (SURVEY.md section 5.8).

Each test spawns REAL OS processes that join one global CPU-device mesh
via jax.distributed (Gloo collectives) and run the framework's actual
programs — sharded reductions, per-host black-box likelihood fan-out,
the adaptive t-pCN sweep, full end-to-end `Sampler.run()` inferences
(device-resident loop AND host orchestration with per-process
shard_callback fan-out), and a mid-run checkpoint resumed under the
mesh.  This is the device-mesh counterpart of the reference's
`mpiexec -n N` integration story
(/root/reference/pocomc/parallel.py:20-178); workers must produce
bit-identical global results (launch() enforces checksum agreement).

The matrix covers the three layouts that break differently:
  * 2 procs x 2 devices — the canonical pod slice; full case set
    including the save_every checkpoint + fresh-Sampler resume.
  * 4 procs x 1 device — more processes than the reference's own CI
    ever runs; device loop + black-box fan-out (which also asserts the
    trimmed-history replication fallback fired inside the run).
  * 3 procs x 1 device — a mesh size that divides NO power of two, so
    the host path's pow2-bucketed training sets exercise the
    indivisible-rows replication fallback inside a full run.
"""

import pytest

from pocomc_tpu.parallel.smoke import launch


def test_two_process_mesh_end_to_end():
    lines = launch(num_processes=2, n_local=2, cases="all", timeout=600.0)
    assert len(lines) == 2
    for ln in lines:
        assert "devices=4" in ln
        # each process's callback saw at most its local rows (16 of 64)
        assert int(ln.split("local_batch_max=")[1].split()[0]) <= 32
        # the full Sampler.run() cases completed with finite evidence
        assert "run_logz_dev=" in ln and "run_logz_host=" in ln
        assert "run_logz_resume=" in ln
        assert "nan" not in ln


@pytest.mark.parametrize("nproc,n_local,cases", [
    (4, 1, "dev,host"),
    (3, 1, "host,resume"),
])
def test_many_process_mesh(nproc, n_local, cases):
    lines = launch(num_processes=nproc, n_local=n_local, cases=cases,
                   timeout=600.0)
    assert len(lines) == nproc
    for ln in lines:
        assert f"devices={nproc * n_local}" in ln
        assert "nan" not in ln
        if "host" in cases:
            assert "run_logz_host=" in ln
        if "resume" in cases:
            assert "run_logz_resume=" in ln
