"""bench.py off the chip: the peak table, the FLOP count from shapes, and
the refusal to measure anything but a GPU."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench  # noqa: E402
from pocomc_tpu.models.flow import Flow  # noqa: E402


@pytest.mark.parametrize("kind, fp32", [
    ("NVIDIA H100 80GB HBM3", 67e12),
    ("NVIDIA H100 PCIe", 51e12),
    ("NVIDIA H100 NVL", 60e12),
])
def test_device_peaks_by_kind(kind, fp32):
    assert bench.device_peaks(kind)["fp32"] == fp32


def test_unknown_device_has_no_peaks():
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("cpu")


def test_flow_inverse_flops_from_shapes():
    # autoregressive: per transform, d MADE passes (d->32->32->32) each
    # keeping one dimension's 23-parameter spline head; plus whitening
    assert bench.flow_inverse_flops(Flow(10, "nsf6")) == (
        2 * 10 * 10 + 6 * 10 * 2 * (10 * 32 + 2 * 32 * 32 + 32 * 23))
    # coupling: one MLP pass per transform on the conditioning half,
    # emitting the other half's heads (halves 25/25 at d=50)
    assert bench.flow_inverse_flops(Flow(50, "nsfc12")) == (
        2 * 50 * 50 + 12 * 2 * (25 * 256 + 2 * 256 * 256 + 256 * 25 * 23))


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU found"):
        bench.require_gpu()
