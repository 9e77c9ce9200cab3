"""Device traces of parts of a run after its window, and the arithmetic
the per-layer readers share.

A part runs under ``torch.profiler`` inside a ``portbench.traced`` record,
between two synchronizations: the steady part with the device's activity
alone (recording the host's operators would slow the host and inflate
the idle share), and a short part with the host's operators too, for the
device time under a host record and the host's work in the idle gaps.
Each Chrome trace goes to a file under ``TMPDIR``, is read back and
removed at once. Busy time is the union of the kernel, copy and memset
spans over all streams, so a copy under a kernel counts once.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TRACED = "portbench.traced"


def union(spans) -> list:
    """Sorted (start, end) spans merged where they overlap."""
    merged = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def handwritten_kernels(csrc_dir: str) -> set:
    """The ``__global__`` function names of the program's CUDA sources."""
    names = set()
    for f in sorted(os.listdir(csrc_dir)):
        if not f.endswith((".cu", ".cuh")):
            continue
        with open(os.path.join(csrc_dir, f)) as fh:
            text = fh.read()
        for m in re.finditer(r"__global__(.*?)\(", text, re.S):
            head = text[m.start():]
            head = head[:head.find("{")] if "{" in head else head
            head = re.sub(r"__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)",
                          "", head)
            found = re.search(r"([A-Za-z_]\w*)\s*\(", head)
            if found:
                names.add(found.group(1))
    return names


def short_kernel_name(name: str) -> str:
    """A demangled kernel name without its return type, anonymous
    namespace and parameter list, at most 120 characters."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                  "")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:120] or "unnamed kernel"


class Trace:
    """The events of one traced part and its length on the host clock."""

    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and e.get("ph") == "X"]
        self.host = [e for e in events if e.get("cat") in HOST_CATS
                     and e.get("ph") == "X"]
        marks = [e for e in self.host if e.get("name") == TRACED]
        self.t0 = min((e["ts"] for e in marks), default=None)
        self.t1 = max((e["ts"] + e["dur"] for e in marks), default=None)

    @staticmethod
    def _span(e):
        return e["ts"], e["ts"] + e["dur"]

    def kernels(self) -> list:
        return [e for e in self.device if e["cat"] == "kernel"]

    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in union(
            self._span(e) for e in self.device)) / 1e6

    def seconds(self, pred) -> float:
        """Summed device seconds of the events whose name ``pred`` takes."""
        return sum(e["dur"] for e in self.device if pred(e["name"])) / 1e6

    def handwritten_s(self, names: set) -> float:
        pats = [re.compile(rf"\b{re.escape(n)}\b") for n in names]
        return sum(e["dur"] for e in self.kernels()
                   if any(p.search(e["name"]) for p in pats)) / 1e6

    def under_op_s(self, op_name: str) -> float:
        """Device seconds of the work launched inside the host record
        ``op_name``: the runtime calls on its thread within its span give
        the correlation ids of the device events."""
        ops = [e for e in self.host if e.get("name") == op_name]
        if not ops:
            return 0.0
        rt = [e for e in self.host if e["cat"] in ("cuda_runtime",
                                                   "cuda_driver")]
        ts = np.array([e["ts"] for e in rt], dtype=np.float64)
        tid = np.array([hash(e.get("tid")) for e in rt], dtype=np.int64)
        corr = np.array([e.get("args", {}).get("correlation", -1)
                         for e in rt], dtype=np.int64)
        ids = set()
        for op in ops:
            sel = ((ts >= op["ts"]) & (ts <= op["ts"] + op["dur"])
                   & (tid == hash(op.get("tid"))))
            ids.update(int(c) for c in corr[sel] if c >= 0)
        return sum(e["dur"] for e in self.device
                   if e.get("args", {}).get("correlation") in ids) / 1e6

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took most time: [[name, seconds]]."""
        by_name = defaultdict(float)
        for e in self.device:
            name = e["name"]
            if e["cat"] == "kernel":
                name = short_kernel_name(name)
            by_name[name] += e["dur"] / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v] for k, v in ops]

    def idle_gaps(self, top: int = 10, labelled: int = 200) -> list:
        """The idle gaps by what the host was doing: the innermost host
        record over each of the ``labelled`` longest gaps, summed by name;
        the shorter gaps summed as one entry. [[name, seconds]]."""
        lo = self.t0 if self.t0 is not None else min(
            (e["ts"] for e in self.device), default=0.0)
        hi = self.t1 if self.t1 is not None else max(
            (e["ts"] + e["dur"] for e in self.device), default=0.0)
        busy = union(self._span(e) for e in self.device)
        gaps, cur = [], lo
        for a, b in busy:
            if a > cur:
                gaps.append((cur, min(a, hi)))
            cur = max(cur, b)
        if hi > cur:
            gaps.append((cur, hi))
        gaps = [(a, b) for a, b in gaps if b > a]
        gaps.sort(key=lambda g: g[0] - g[1])
        inner = [e for e in self.host if e.get("name") != TRACED]
        starts = np.array([e["ts"] for e in inner], dtype=np.float64)
        ends = starts + np.array([e["dur"] for e in inner], dtype=np.float64)
        durs = ends - starts
        by_host = defaultdict(float)
        for a, b in gaps[:labelled]:
            mid = (a + b) / 2.0
            cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = ("host outside any torch record" if cover.size == 0 else
                     inner[int(cover[np.argmin(durs[cover])])]["name"])
            by_host[label] += (b - a) / 1e6
        rest = sum(b - a for a, b in gaps[labelled:]) / 1e6
        if rest > 0:
            by_host[f"gaps shorter than the {labelled} longest"] += rest
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v] for k, v in idle]


def capture(fn, host: bool):
    """Run ``fn()`` under the profiler between two synchronizations:
    (Trace, what ``fn`` returned). ``host`` records the host's operators
    too, which costs the host time on every operator; without it only
    the device's activity and the runtime calls are recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function(TRACED):
            info = fn()
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events, window), info
