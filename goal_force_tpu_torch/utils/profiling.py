"""Profiling and timing harness.

Port of ``goal_force_tpu/utils/profiling.py``:

  - ``timeit(fn, *args)``: mean wall-clock seconds per call after a warm-up, the card
    synchronised (``torch.cuda.synchronize``) where JAX blocks on the result;
  - ``trace(log_dir)``: a ``torch.profiler`` context over the host and (where there is
    one) the card; on exit it writes the chrome trace as ``<log_dir>/<time>.pt.trace.json.gz``;
  - ``top_ops(log_dir, k)``: (name, total ms, count) of the device ops in the newest
    ``*.trace.json.gz`` under ``log_dir``, largest first.

JAX's ``top_ops`` keeps every complete ("ph": "X") event. A torch trace puts its host
events (``cpu_op``, ``python_function``, ``cuda_runtime``, ...) on the same list, so the
port keeps only torch's device categories (``DEVICE_CATEGORIES``); on a trace that holds
only such events the two agree. ``device_share(log_dir)`` gives the union of the device
events' intervals and the trace's whole window, both in ms: the card's busy share.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn: Callable, *args, reps: int = 3, warmup: int = 1, **kwargs) -> float:
    """Mean wall-clock seconds per call (device-synchronized)."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args, **kwargs)
    _synchronize()
    return (time.perf_counter() - t0) / reps


@contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        _synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"{time.time_ns()}.pt.trace.json.gz"))


def _newest_events(log_dir: str) -> List[Dict]:
    paths = sorted(glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        return []
    with gzip.open(paths[-1], "rt") as f:
        return json.load(f).get("traceEvents", [])


def _complete(ev: Dict) -> bool:
    return ev.get("ph") == "X" and "dur" in ev


def top_ops(log_dir: str, k: int = 25) -> List[Tuple[str, float, int]]:
    """Aggregate (name, total_ms, count) of the device events of the newest trace."""
    totals: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for ev in _newest_events(log_dir):
        if not _complete(ev) or ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        name = ev.get("name", "")
        totals[name] += ev["dur"] / 1000.0
        counts[name] += 1
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
    return [(name, ms, counts[name]) for name, ms in ranked]


def device_share(log_dir: str) -> Tuple[float, float]:
    """(ms in which at least one device event ran, ms from the trace's first event's
    start to its last event's end) of the newest trace."""
    spans, lo, hi = [], float("inf"), float("-inf")
    for ev in _newest_events(log_dir):
        if not _complete(ev):
            continue
        start, end = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        lo, hi = min(lo, start), max(hi, end)
        if ev.get("cat") in DEVICE_CATEGORIES:
            spans.append((start, end))
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy / 1000.0, (hi - lo) / 1000.0 if hi > lo else 0.0
