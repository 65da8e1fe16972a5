"""Profiling and debug switches.

Counterpart of ``autoawq_tpu/utils/profiling.py`` (``trace`` :27,
``summarize_trace`` :35, ``print_trace_summary`` :63,
``enable_nan_checks`` :68), on ``torch.profiler``:

* :func:`trace` — a context manager that records the block with
  ``torch.profiler`` (host operators, and the device's kernels on a card,
  after a burst of ``spin_kernel`` launches of its own) and writes a Chrome
  trace, ``trace.json``, into ``log_dir``.
* :func:`flush_device` — that burst alone (``SPIN_KERNEL`` names its rows).
* :func:`device_kernels` — a callable under ``torch.profiler`` after that
  burst: its wall time and the device's kernels by name (count and µs),
  the burst's rows left out; what every reader of kernel counts or device
  time builds on.
* :func:`summarize_trace` — reads that trace back into a table of device
  kernels by name (total µs and count), so the port's own kernels (K1's
  ``DenseJob``, K3's ``PairJob`` and ``DownJob``, ...) show beside the
  library's; a trace with no device kernel (a CPU run) gives its host
  operators instead.
* :func:`enable_nan_checks` — JAX's ``jax_debug_nans`` has no torch
  counterpart. Here the switch turns on autograd's anomaly mode (a NaN
  made in a backward raises, naming the forward operator) and a check of
  the logits of every ``nn/modules.logits_fn`` call (``forward``,
  ``prefill``, each decode step): a NaN there raises FloatingPointError.
  The check reads the device from the host each call, so it is off by
  default; ``AWQ_TPU_DEBUG_NANS=1`` turns it on at import, as in JAX.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import re
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

NAN_CHECKS = False
# What a card's trace runs before its block. torch.profiler lost the first
# kernel records of a trace on an H100: up to a few tens, more the longer the
# process had profiled, and once with the device's timestamps mapped ms
# before the host's. So a burst of one-cycle ``spin_kernel`` launches goes
# first (they show in the summary under that name), then a short wait.
FLUSH_KERNELS = 1024
DEVICE_CLOCK_MARGIN_S = 0.05
SPIN_KERNEL = "spin_kernel"


def flush_device(device) -> None:
    """Inside a running profiler on a card: ``FLUSH_KERNELS`` one-cycle
    ``spin_kernel`` launches, a sync and a short wait, so that the records
    the profiler loses first are these and not the block's. A no-op for a
    CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    with torch.cuda.device(device):
        for _ in range(FLUSH_KERNELS):
            torch.cuda._sleep(1)
    torch.cuda.synchronize(device)
    time.sleep(DEVICE_CLOCK_MARGIN_S)


def device_kernels(run: Callable[[], Any], device=None,
                   host_ops: bool = False
                   ) -> Tuple[Any, float, Dict[str, Tuple[int, float]]]:
    """``run()`` under ``torch.profiler``, its window opened by
    :func:`flush_device`'s burst: -> (run's result, its wall seconds up to
    a sync, {device kernel name: (count, total µs)}), the burst's rows left
    out. ``host_ops`` records the host's operators too; off, a call of tens
    of thousands of host operators keeps the profiler's read-back short. On
    a CPU device ``run()`` is timed alone and the table is empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from autoawq_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        t = time.perf_counter()
        out = run()
        return out, time.perf_counter() - t, {}
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        flush_device(device)
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and SPIN_KERNEL not in e.key:
            n, us = kernels.get(e.key, (0, 0.0))
            kernels[e.key] = (n + e.count, us + e.self_device_time_total)
    return out, wall, kernels


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, device=None):
    """Profile the block; yields ``log_dir`` (default: a folder under the
    temporary directory), where ``trace.json`` lands on exit. ``device``
    None means the card, whose kernels are recorded too; a CPU device
    records host operators only."""
    from torch.profiler import ProfilerActivity, profile

    from autoawq_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "autoawq_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    cuda = device.type == "cuda"
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        flush_device(device)
        yield log_dir
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def summarize_trace(log_dir: str, top: Optional[int] = 25,
                    group: bool = True) -> List[Tuple[str, float, int]]:
    """-> [(name, total_us, count)], longest first (``top`` rows, all with
    None): the device's kernels of the newest trace in ``log_dir``, or its
    host operators where it holds no kernel. ``group`` merges names that
    differ only in a trailing ``.N``, as JAX's does."""
    files = sorted(glob.glob(os.path.join(log_dir, "*.json")),
                   key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no trace files under {log_dir}")
    with open(files[-1]) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    cat = ("kernel" if any(e.get("cat") == "kernel" for e in events)
           else "cpu_op")
    agg: Dict[str, float] = collections.Counter()
    cnt: Dict[str, int] = collections.Counter()
    for e in events:
        if e.get("cat") == cat:
            name = re.sub(r"\.\d+$", "", e["name"]) if group else e["name"]
            agg[name] += float(e["dur"])
            cnt[name] += 1
    rows = sorted(agg.items(), key=lambda kv: -kv[1])
    return [(n, d, cnt[n]) for n, d in rows[:top]]


def print_trace_summary(log_dir: str, top: int = 25) -> None:
    for name, us, n in summarize_trace(log_dir, top):
        print(f"{us:10.1f} us  x{n:6d}  {name[:90]}")


def enable_nan_checks(enable: bool = True) -> None:
    """Autograd's anomaly mode and the logits' NaN check, on or off."""
    global NAN_CHECKS
    NAN_CHECKS = bool(enable)
    torch.autograd.set_detect_anomaly(NAN_CHECKS)


def check_nans(name: str, x: torch.Tensor) -> None:
    """Raise FloatingPointError if ``x`` holds a NaN (with the checks on)."""
    if NAN_CHECKS and bool(torch.isnan(x).any()):
        raise FloatingPointError(f"NaN in {name}")


if os.environ.get("AWQ_TPU_DEBUG_NANS") == "1":
    enable_nan_checks(True)
