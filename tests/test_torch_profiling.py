"""``utils/profiling.py`` of the port against the JAX package's.

``top_ops`` on one synthetic gzipped chrome trace of device events equals JAX's exactly;
on a trace that also holds torch's host events (``cpu_op``, ``python_function``,
``cuda_runtime``) the port keeps only the device ones, where JAX's keeps every complete
event; ``trace`` on the CPU writes a ``*.trace.json.gz`` that ``top_ops`` and
``device_share`` read; ``timeit`` calls its function warm-up + reps times and returns
the mean seconds."""

import gzip
import json
import os

import torch

from goal_force_tpu.utils import profiling as jprof

from goal_force_tpu_torch.utils import profiling as tprof


def _write(root, events, name="a.trace.json.gz"):
    path = os.path.join(root, "plugins", "profile", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return path


DEVICE = [
    {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 0, "dur": 1500},
    {"ph": "X", "cat": "kernel", "name": "softmax", "ts": 1600, "dur": 250},
    {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 2000, "dur": 1250},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 3300, "dur": 40},
    {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 3400, "dur": 10},
    {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3500},
    {"ph": "X", "cat": "kernel", "name": "no_duration", "ts": 3600},
]
HOST = [
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 9000},
    {"ph": "X", "cat": "python_function", "name": "forward", "ts": 0, "dur": 12000},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 5},
]


def test_top_ops_matches_jax_on_device_events(tmp_path):
    _write(str(tmp_path), DEVICE)
    want = jprof.top_ops(str(tmp_path), k=3)
    got = tprof.top_ops(str(tmp_path), k=3)
    assert got == want == [("gemm", 2.75, 2), ("softmax", 0.25, 1), ("Memcpy HtoD", 0.04, 1)]
    assert tprof.top_ops(str(tmp_path / "empty")) == jprof.top_ops(str(tmp_path / "empty")) == []


def test_top_ops_drops_host_events(tmp_path):
    """The newest file is read; JAX's ranks the host events first, the port's keeps the
    device events only, and device_share unions them over the trace's window."""
    old = _write(str(tmp_path), DEVICE, "old.trace.json.gz")
    os.utime(old, (1, 1))
    _write(str(tmp_path), DEVICE + HOST, "new.trace.json.gz")
    assert jprof.top_ops(str(tmp_path), k=2) == [("forward", 12.0, 1), ("aten::mm", 9.0, 1)]
    assert tprof.top_ops(str(tmp_path), k=2) == [("gemm", 2.75, 2), ("softmax", 0.25, 1)]
    busy, window = tprof.device_share(str(tmp_path))
    assert (busy, window) == (3.05, 12.0)


def test_trace_on_the_cpu_writes_a_readable_file(tmp_path):
    log_dir = str(tmp_path / "trace")
    x = torch.randn(64, 64)
    with tprof.trace(log_dir) as d:
        y = (x @ x).relu().sum()
    assert d == log_dir and float(y) > 0
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json.gz")]
    assert len(files) == 1
    with gzip.open(os.path.join(log_dir, files[0]), "rt") as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    assert tprof.top_ops(log_dir) == []          # no device on the CPU
    busy, window = tprof.device_share(log_dir)
    assert busy == 0.0 and window > 0.0


def test_timeit_counts_calls_and_returns_mean_seconds():
    calls = []
    secs = tprof.timeit(lambda a, b=0: calls.append((a, b)), 1, b=2, reps=4, warmup=2)
    assert calls == [(1, 2)] * 6 and 0.0 <= secs < 1.0
