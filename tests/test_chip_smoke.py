"""chip_smoke.py off the chip: it must refuse to run without a GPU, and
its phases are rehearsed here on virtual CPU devices at a tiny size, so
that a wrong argument, path or control flow shows before a chip run.
The logZ bars are wide: at this size the runs check control flow, not
accuracy (the chip run holds the real bars)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

TINY = dict(n_effective=128, n_active=64, flow="nsf3",
            train_config=dict(epochs=20, patience=3))
RUN = dict(n_total=128, n_evidence=128, bar=2.0)


def _run_script(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_refuses_to_run_without_gpu():
    res = _run_script(REPO)
    assert res.returncode != 0
    assert "no GPU found" in res.stderr
    assert '"ok"' not in res.stdout
    assert "quickstart" not in res.stdout  # no phase ran on the CPU


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_script(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_quickstart_phase():
    s = cs.phase_quickstart(**RUN, **TINY)
    assert s._live_stats and s._use_device_loop()


def test_gauss50_phase():
    cs.phase_gauss50(d=4, **RUN, **TINY)


def test_callback_phases():
    assert cs.phase_numpy_callback(**RUN, **TINY)._sweep_mode == "fused"
    assert cs.phase_blobs(**RUN, **TINY)._sweep_mode == "stepped"
    cs.phase_checkpoint(**RUN, **TINY)


def test_compare_phase(capsys):
    cs.phase_compare(jax.devices()[0], jax.devices()[1], d=4,
                     flows=("nsf3", "nsfc3"), n=64, sweep_flow="nsfc3",
                     sweep_n=64, big_n=128)
    out = capsys.readouterr().out
    assert out.count("-> ok") == 12 and "FAIL" not in out
    assert "t-pCN quadratic form" in out and "CompiledMemoryStats" in out


def test_compare_phase_flags_a_deviation(monkeypatch):
    # a flow that disagrees between the two devices must fail the phase
    monkeypatch.setattr(cs, "FLOW_TOL", -1.0)
    with pytest.raises(RuntimeError, match="card against host"):
        cs.phase_compare(jax.devices()[0], jax.devices()[1], d=4,
                         flows=("nsf3",), n=64, sweep_flow="nsfc3",
                         sweep_n=64, big_n=64)


def test_mesh_phase(capsys):
    cs.phase_mesh(jax.devices()[:4], gauss_kw=dict(d=4, **RUN, **TINY),
                  callback_kw=dict(**RUN, **TINY))
    assert "sharded over [4] device(s)" in capsys.readouterr().out


@pytest.mark.gpu
def test_compare_phase_on_gpu(gpu):
    cs.phase_compare(gpu, jax.devices("cpu")[0], d=10,
                     flows=("nsf6", "nsfc6"), n=1024, sweep_flow="nsfc6",
                     sweep_n=1024, big_n=4096)
