"""tools/profile_report.py on a small trace recorded on an NVIDIA H100:
three fused wavefront steps (CUDA DP + walk, 64 pairs at W=128) inside a
`telr_stage:dp` annotation."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))

import profile_report  # noqa: E402

DATA = os.path.join(HERE, "data")


def test_xplane_gpu_device_time_attributed_to_stage():
    report = profile_report.build_report_xplane(
        os.path.join(DATA, "gpu_trace.xplane.pb"))
    assert report["device_lanes"] == ["/device:GPU:0"]
    (row,) = report["stages"]
    assert row["stage"] == "dp"
    assert 0 < row["device_s"] <= row["wall_s"]
    assert report["device_total_s"] >= row["device_s"]


def test_perfetto_fallback_finds_gpu_lanes():
    """The perfetto export keeps the device lanes (its host spans depend on
    the tracer level, so only device time is checked)."""
    report = profile_report.build_report(profile_report.load_trace(DATA))
    assert report["device_lanes"] == ["/device:GPU:0"]
    assert report["device_total_s"] > 0
