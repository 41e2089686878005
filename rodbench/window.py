"""One measured run of one cell: set-up, the closed-loop window, the traced
sample, the check against the reference, and the reduction to metrics.

Closed loop: one caller sends the pool's batches in turn, each call waited
for (synchronised) before the next is sent.  Each call's latency is taken
by CUDA events around it on the card's clock; the window's length and the
set-up by the host clock.  With ``--trace 1`` the profiler records a short
run of calls inside the window (``trace_after_calls``, ``trace_calls`` of
the mix), wrapped in this benchmark's spans: ``rodbench.batch`` (call and
wait) and ``rodbench.call`` (call only).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import pathlib
import random
import time

import torch

HERE = pathlib.Path(__file__).resolve().parent
BATCH_SPAN, CALL_SPAN = "rodbench.batch", "rodbench.call"
# Host ops of the program that wait for the device.
SYNC_OPS = ("aten::item", "aten::_local_scalar_dense", "aten::is_nonzero")
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float            # first traced call's start to the last's end
    busy_s: float              # union of the device's operations in it
    calls: int
    events: list               # (name, start_s, end_s) of the device's operations
    idle_gaps: list            # (kind, seconds), summed by what the host was doing


@dataclasses.dataclass
class Records:
    """What a metric's reader reads."""

    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window_s: float            # the whole measured window
    calls: list                # (start, return, done) host seconds of each call
    latencies_ms: list         # each call, call to results ready, on the card's clock
    items: int                 # rods or load cases done in the window
    counters: dict
    profiled: range            # indices of the traced calls
    trace: Trace | None


def load_entry(name: str):
    return importlib.import_module(f"rodbench.entries.{name}")


def load_reader(metric: str):
    """``rodbench/metrics/<metric>.py``, loaded by its file name."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"rodbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Reservoir:
    """A uniform sample of ``k`` calls of the window, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items = k, random.Random(seed), []

    def offer(self, index: int, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(index + 1)
            if j < self.k:
                self.items[j] = item


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(bench, traffic: dict, seconds: float, trace: bool, device, seed: int):
    """The closed loop.  Returns ``(calls, latencies_ms, kept, profiled, prof)``."""
    cuda = device.type == "cuda"
    pool = traffic["pool"]
    first = traffic["trace_after_calls"]
    profiled = range(first, first + traffic["trace_calls"]) if trace else range(0)
    reservoir = Reservoir(traffic["check_calls"], seed)
    calls, events, prof = [], [], None
    t_window = time.perf_counter()
    deadline = t_window + seconds
    index = 0
    while time.perf_counter() < deadline:
        slot = index % pool
        if index == profiled.start and trace:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if cuda else []))
            prof.start()
        spans = index in profiled
        batch_span = torch.profiler.record_function(BATCH_SPAN) if spans else None
        if batch_span:
            batch_span.__enter__()
        start = torch.cuda.Event(enable_timing=True) if cuda else None
        end = torch.cuda.Event(enable_timing=True) if cuda else None
        if cuda:
            start.record()
        t0 = time.perf_counter()
        if spans:
            with torch.profiler.record_function(CALL_SPAN):
                out = bench.call(slot)
        else:
            out = bench.call(slot)
        t_ret = time.perf_counter()
        if cuda:
            end.record()
            end.synchronize()
        t_done = time.perf_counter()
        if batch_span:
            batch_span.__exit__(None, None, None)
        calls.append((t0 - t_window, t_ret - t_window, t_done - t_window))
        events.append((start, end))
        bench.after_call(index, slot, out)
        reservoir.offer(index, (slot, out))
        del out
        if prof is not None and index == profiled.stop - 1:
            prof.stop()
        index += 1
    if prof is not None and index < profiled.stop:
        prof.stop()
        profiled = range(profiled.start, index)
    latencies = ([s.elapsed_time(e) for s, e in events] if cuda
                 else [1e3 * (d - s) for s, _, d in calls])
    return calls, latencies, reservoir.items, profiled, prof


def warm_profiler(device) -> None:
    """Start and stop the profiler once, so that its first start (seconds of
    tracer set-up) falls into the set-up and not into the traced window."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])):
        torch.ones(8, device=device).sum()
        _sync(device)


def _short(name: str) -> str:
    """A device operation's name without its namespace noise and argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    cut = name.find("(")
    return name[:cut].rstrip() if cut > 0 else name


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_trace(prof, sync_gap: str) -> Trace | None:
    """The traced calls' device operations, the card's busy time as the union
    of their intervals, and the idle gaps summed by what the host was doing:
    returning from the program's own wait for the device (``sync_gap``),
    between this benchmark's batches (``between_batches``), or issuing
    work (``host_enqueue``)."""
    device, batches, calls, syncs = [], [], [], []
    for evt in prof.events():
        s, e = evt.time_range.start / 1e6, evt.time_range.end / 1e6
        if evt.name in (BATCH_SPAN, CALL_SPAN) and evt.device_type != torch.autograd.DeviceType.CPU:
            continue                  # the spans' own marks on the device's timeline
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device.append((_short(evt.name), s, e))
        elif evt.name == BATCH_SPAN:
            batches.append((s, e))
        elif evt.name == CALL_SPAN:
            calls.append((s, e))
        elif evt.name in SYNC_OPS:
            syncs.append(e)
    if not batches or not device:
        return None
    lo, hi = min(s for s, _ in batches), max(e for _, e in batches)
    device = [(n, max(s, lo), min(e, hi)) for n, s, e in device if e > lo and s < hi]
    busy = _union([(s, e) for _, s, e in device])
    gaps, prev = {}, lo
    for s, e in busy + [[hi, hi]]:
        if s > prev:
            gaps_kind = _gap_kind(prev, s, batches, calls, syncs, sync_gap)
            gaps[gaps_kind] = gaps.get(gaps_kind, 0.0) + (s - prev)
        prev = max(prev, e)
    return Trace(window_s=hi - lo, busy_s=sum(e - s for s, e in busy), calls=len(batches),
                 events=device, idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1]))


def _gap_kind(g0, g1, batches, calls, syncs, sync_gap):
    if any(g0 < s <= g1 for s, _ in batches) or not any(s <= g0 and g1 <= e for s, e in calls):
        return "between_batches"
    if any(g0 - 20e-6 <= t <= g1 for t in syncs):
        return sync_gap
    return "host_enqueue"


def breakdown(trace: Trace) -> dict:
    by_name = {}
    for name, s, e in trace.events:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, t] for n, t in ops],
            "idle_gaps": [[n, t] for n, t in trace.idle_gaps[:TOP]]}


def measure(cell: dict, config: dict, traffic: dict, metrics: list, seed: int,
            seconds: float, trace: bool, device, t_start: float) -> tuple:
    """One run.  Returns ``(result line as a dict, check lines)``."""
    marks = [("to the harness", time.perf_counter())]
    entry = load_entry(config["entry"])
    marks.append(("program import", time.perf_counter()))
    bench = entry.Bench(config, traffic, seed, device)
    _sync(device)
    marks.append(("inputs", time.perf_counter()))
    for w in range(traffic["warm_calls"]):
        bench.call(w % traffic["pool"])
    if trace:
        warm_profiler(device)
    _sync(device)
    marks.append(("warm calls", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    stages = ", ".join(f"{name} {t - prev:.3f}" for (name, t), prev
                       in zip(marks, [t_start] + [t for _, t in marks]))

    calls, latencies, kept, profiled, prof = run_window(bench, traffic, seconds, trace,
                                                        device, seed)
    window_s = calls[-1][2] if calls else 0.0
    items, counters = bench.finish(len(calls))
    traced = reduce_trace(prof, entry.SYNC_GAP) if prof is not None else None
    prof = None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    t_check = time.perf_counter()
    checks, failed = bench.check(kept, config["check"])
    t_check = time.perf_counter() - t_check
    rec = Records(cell=cell, config=config, traffic=traffic, setup_s=setup_s,
                  window_s=window_s, calls=calls, latencies_ms=latencies, items=items,
                  counters=counters, profiled=profiled, trace=traced)
    values = {}
    for metric in metrics:
        value = load_reader(metric["name"]).read(rec)
        if value is not None:
            values[metric["name"]] = {"value": value, "unit": metric["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    line = {"correct": all(_within(v, limit) for v, limit in checks.values()),
            "attempted": len(calls) * traffic["batch"], "failed": failed,
            "metrics": values, "device": dev}
    if trace:
        dev["busy_s"] = traced.busy_s if traced else 0.0
        dev["window_s"] = traced.window_s if traced else 0.0
        if traced:
            line["breakdown"] = breakdown(traced)
    line["checks"] = {name: {"value": v, "limit": limit} for name, (v, limit) in checks.items()}
    lines = [f"rodbench: {len(calls)} calls, set-up {setup_s:.3f} s, window {window_s:.3f} s, "
             f"check {t_check:.3f} s, inputs redrawn {bench.redrawn}",
             f"rodbench: set-up stages (s): {stages}"]
    lines += [f"check {name}: {v!r} (limit {limit!r})" for name, (v, limit) in checks.items()]
    return line, lines


def _within(value, limit) -> bool:
    return value == value and value <= limit
