"""The benchmark's common harness: the cell's files found by name, the run's
facts, the traced window, the import guard and the result line.

Everything that belongs to one configuration, one workload (traffic mix)
or one per-layer metric lives in a file of its own, found by the name
``BENCHMARK.json`` gives it:

  benchmark/configs/<config>.json     sizes of one model configuration,
                                      and under ``reference`` the file
                                      of its backbone's plain forward,
                                      operation count and feature width
                                      (``reference/backbone.py``)
  benchmark/workloads/<cell>.json     one cell: its job kind, parameters
                                      and the limits of its output checks
  benchmark/jobs/<job>.py             one driver per job kind: ``run(ctx)``
  benchmark/metrics/<metric>.py       one reader per per-layer metric:
                                      ``read(records) -> float | None``

A new configuration, cell or per-layer metric is one new file and one new
entry in ``BENCHMARK.json``; nothing here names a cell.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import platform
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SPEC_FILE = ROOT / "BENCHMARK.json"

# top-level module names that no process of the benchmark may hold: JAX,
# its libraries, and the JAX package the port was made from (compared
# whole, so the port, whose name begins with it, is not caught)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "subspace_reg_tpu")

# published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W)
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


class BenchError(RuntimeError):
    """A run that cannot produce a result (no card, a missing file)."""


# --------------------------------------------------------------------------
# files found by name
# --------------------------------------------------------------------------
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(path: Path = SPEC_FILE) -> dict:
    if not path.exists():
        raise BenchError(f"{path} not found")
    return load_json(path)


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module of its own (names may hold
    dots and dashes, so not through the import system's dotted paths)."""
    if not path.exists():
        raise BenchError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(
        "bench_" + "".join(c if c.isalnum() else "_" for c in name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One cell of ``BENCHMARK.json`` with everything found by its names."""
    name: str
    entry: dict              # the ``workloads`` entry
    config: dict             # the configuration file's contents, its
                             # ``reference`` file's path made absolute
    workload: dict           # benchmark/workloads/<name>.json
    end_to_end: List[dict]   # end-to-end metrics this cell reports
    per_layer: List[dict]    # per-layer metrics this cell reports


def _applies(metric: dict, cell: str, e2e_names) -> bool:
    """A per-layer metric is reported in the cells it lists, or, listing
    none, in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def find_cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    """Cell ``name`` of ``spec`` with its files under ``root``."""
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    # the backbone reference lies in the checkout the cell was found in
    config["reference"] = str(root / config["reference"])
    workload = load_json(root / "benchmark" / "workloads" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, names)]
    return Cell(name=name, entry=entry, config=config, workload=workload,
                end_to_end=e2e, per_layer=per_layer)


def job_module(kind: str, root: Path = ROOT):
    return load_module(root / "benchmark" / "jobs" / f"{kind}.py",
                       f"job_{kind}")


def metric_reader(name: str, root: Path = ROOT):
    return load_module(root / "benchmark" / "metrics" / f"{name}.py",
                       f"metric_{name}")


# --------------------------------------------------------------------------
# the run's facts
# --------------------------------------------------------------------------
def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of
    its start (so the interpreter's own start-up counts)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def _nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return " | ".join(line.strip() for line in out.stdout.splitlines()
                      if line.strip()) or "unavailable"


def _cpu_model() -> str:
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=30, check=False).stdout
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    for line in out.splitlines():
        if line.strip().startswith("Model name"):
            return f"{line.split(':', 1)[1].strip()} ({platform.machine()})"
    return platform.processor() or platform.machine() or "unknown"


def facts(torch, chips: int) -> Dict[str, Any]:
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "python": platform.python_version(), "cpu": _cpu_model(),
           "cpu_count": os.cpu_count()}
    if torch.cuda.is_available():
        out["card"] = torch.cuda.get_device_name(0)
        out["card_count"] = torch.cuda.device_count()
        out["cards_used"] = chips
        out["nvidia_smi"] = _nvidia_smi()
    return out


def say(line: str) -> None:
    """A fact of the run: printed before the result line."""
    print(f"# {line}", flush=True)


# --------------------------------------------------------------------------
# the traced window
# --------------------------------------------------------------------------
# the tracer's own activity records, which it files as device events
TRACER_OVERHEAD = ("Command Buffer Full", "Buffer Flush",
                   "Activity Buffer Request")
WINDOW_SPAN = "bench.window"


@dataclass
class Trace:
    """A profiled span's device and host records, in ns on one clock:
    ``device`` (name, start, end) of every operation that ran on the
    device (kernels, copies, fills), ``host`` (name, start, end) of the
    host's operations and the benchmark's own spans, and the span."""
    device: List[Tuple[str, int, int]]
    host: List[Tuple[str, int, int]]
    span: Tuple[int, int]
    # a trace of the device alone has no host span: its window is the
    # host clock's, between two synchronizations
    host_window_s: Optional[float] = None

    @property
    def window_s(self) -> float:
        if self.host_window_s is not None:
            return self.host_window_s
        return (self.span[1] - self.span[0]) * 1e-9

    def kernels(self) -> List[Tuple[str, int, int]]:
        """The device records that are kernels (no copies or fills)."""
        return [e for e in self.device
                if not e[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device records' intervals inside the span."""
        lo, hi = self.span
        if self.host_window_s is not None:
            lo, hi = -2 ** 63, 2 ** 63
        spans = sorted((max(a, lo), min(b, hi)) for _, a, b in self.device
                       if b > lo and a < hi)
        out: List[Tuple[int, int]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                if b > out[-1][1]:
                    out[-1] = (out[-1][0], b)
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def device_time_s(self, marks=None, exclude=()) -> float:
        """Summed device time of the records whose name holds one of
        ``marks`` (all records when None) and none of ``exclude``."""
        tot = 0
        for name, a, b in self.device:
            if marks is not None and not any(m in name for m in marks):
                continue
            if any(m in name for m in exclude):
                continue
            tot += b - a
        return tot * 1e-9

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for name, a, b in self.device:
            by[name] = by.get(name, 0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest stretches of the span with nothing on the
        device, each named by what the host was doing in its middle: the
        benchmark's span and the innermost host operation there."""
        if self.host_window_s is not None:
            return []
        lo, hi = self.span
        gaps, t = [], lo
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        out = []
        for a, b in gaps:
            mid = (a + b) // 2
            inner, outer = None, None
            for name, s, e in self.host:
                if s <= mid <= e:
                    if name.startswith("bench.") and name != WINDOW_SPAN:
                        if outer is None or e - s < outer[1]:
                            outer = (name, e - s)
                    elif not name.startswith("bench."):
                        if inner is None or e - s < inner[1]:
                            inner = (name, e - s)
            label = " > ".join(x[0] for x in (outer, inner) if x) or "host"
            out.append([label[:120], (b - a) * 1e-9])
        return out


def _kineto_events(prof):
    return prof.profiler.kineto_results.events()


def trace_of(prof, host_window_s: Optional[float] = None) -> Trace:
    """The window's records from a ``torch.profiler.profile`` whose traced
    stretch lay inside a ``record_function(WINDOW_SPAN)``, or, with
    ``host_window_s``, of a profile of the device alone."""
    from torch.autograd import DeviceType
    device, host, span = [], [], None
    for e in _kineto_events(prof):
        name = e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        if name in TRACER_OVERHEAD:
            continue
        if e.device_type() == DeviceType.CUDA:
            # the benchmark's spans are mirrored on the device's timeline
            # as annotations: they are not device work
            if not (e.is_user_annotation() or name.startswith("bench.")):
                device.append((name, a, b))
        else:
            host.append((name, a, b))
            if name == WINDOW_SPAN:
                span = (a, b)
    if host_window_s is not None:
        return Trace(device=device, host=host, span=(0, 0),
                     host_window_s=host_window_s)
    if span is None:
        raise BenchError(f"the trace holds no {WINDOW_SPAN!r} span")
    return Trace(device=device, host=host, span=span)


@contextlib.contextmanager
def traced(enabled: bool, torch, sink: list, host_ops: bool = True):
    """Profile the block when ``enabled`` and append its ``Trace`` to
    ``sink``.  The device is synchronized at both ends, so the span covers
    the work.  ``host_ops=False`` records the device alone: recording
    every host operation costs ~20 us each, which near doubles a step of
    ~2000 launches, while the device's own records cost little; the
    window is then the host clock's."""
    from torch.profiler import ProfilerActivity, profile, record_function
    if not enabled:
        yield
        return
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if cuda else []
    if host_ops or not cuda:
        acts.append(ProfilerActivity.CPU)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with profile(activities=acts) as prof:
        if ProfilerActivity.CPU in acts:
            with record_function(WINDOW_SPAN):
                sync()
                yield
                sync()
            window = None
        else:
            sync()
            t0 = time.perf_counter()
            yield
            sync()
            window = time.perf_counter() - t0
    sink.append(trace_of(prof, window))


def span(torch, name: str):
    """A host span of the benchmark's own, around a call into a layer."""
    return torch.profiler.record_function(f"bench.{name}")


# --------------------------------------------------------------------------
# checks of the output and the result
# --------------------------------------------------------------------------
@dataclass
class Check:
    """One number compared, beside its limit: passes when ``value <=
    limit`` (``nan`` never passes)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return (not math.isnan(self.value)) and self.value <= self.limit


@dataclass
class Outcome:
    """What a job returns: the end-to-end values, the records the
    per-layer readers take, the checks of the output, and counts."""
    e2e: Dict[str, float]
    records: Dict[str, Any]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    traces: List[Trace] = field(default_factory=list)
    window_facts: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Context:
    """What a job is handed."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    torch: Any
    setup_done: Callable[[], float]   # call when set-up ends: returns s
    # the CPU tests': "config", "workload", "sizes" (the model builder's
    # tiny sizes), "control"
    overrides: Dict[str, Any] = field(default_factory=dict)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", spec: Optional[dict] = None,
             overrides: Optional[Dict[str, Any]] = None,
             t_started: Optional[float] = None, root: Path = ROOT) -> dict:
    """One run of cell ``name``: returns the result object (not printed).
    ``device`` other than "cuda" and ``overrides`` are for the CPU tests;
    the command line always asks for the card."""
    import torch
    spec = spec or load_spec(root / "BENCHMARK.json")
    cell = find_cell(spec, name, root)
    chips = int(cell.entry["chips"])
    if device == "cuda":
        if not torch.cuda.is_available():
            raise BenchError("torch.cuda.is_available() is false: the "
                             "benchmark measures the card and runs nowhere "
                             "else")
        if torch.cuda.device_count() < chips:
            raise BenchError(f"the cell asks for {chips} cards, "
                             f"{torch.cuda.device_count()} present")
    age0 = process_age_s() if t_started is None else None
    t0 = time.perf_counter()

    def setup_done() -> float:
        if age0 is not None:
            return age0 + time.perf_counter() - t0
        return time.time() - t_started

    for k, v in facts(torch, chips).items():
        say(f"{k}: {v}")
    say(f"cell {name}: config {cell.entry['config']}, job "
        f"{cell.workload['job']}, seed {seed}, run_seconds {seconds}, "
        f"trace {int(trace)}")
    job = job_module(cell.workload["job"], root)
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                  device=device, torch=torch, setup_done=setup_done,
                  overrides=dict(overrides or {}))
    out = job.run(ctx)
    for k, v in out.window_facts.items():
        say(f"{k}: {v}")
    if trace:
        metrics = {}
        records = dict(out.records, traces=out.traces, cell=cell,
                       peak_flops=PEAK_FLOPS, hbm_bytes_per_s=HBM_BYTES_PER_S)
        for m in cell.per_layer:
            value = metric_reader(m["name"], root).read(records)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out.e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else platform.processor() or "cpu"),
           "count": chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": all(c.ok for c in out.checks) and bool(out.checks),
              "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": dev}
    if trace and out.traces:
        dev["busy_s"] = out.traces[0].busy_s()
        dev["window_s"] = out.traces[0].window_s
        main = out.traces[0]
        # the gaps are named from a trace that recorded the host's spans
        labelled = next((t for t in out.traces if t.host_window_s is None),
                        main)
        result["breakdown"] = {"device_ops": main.top_ops(),
                               "idle_gaps": labelled.idle_gaps()}
    if "control" in out.window_facts:
        result["control"] = out.window_facts["control"]
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in out.checks}
    return result


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        description="Run one cell of the benchmark on the card and print "
                    "its result as the last line of standard output.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {', '.join(found)} after the "
              "window; the port must not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
