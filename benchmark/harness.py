"""What every cell of the benchmark shares: the manifest and the files it
names, the device checks, the cache directories, the clock, the trace's
reduction to busy time and breakdowns, the per-layer readers and the
result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its
configuration is ``benchmark/configs/<config>.json``, its traffic
``benchmark/traffic/<traffic>.json``, whose ``entry`` names the driver
``benchmark/drivers/<entry>.py``; a per-layer metric ``<name>`` is read by
``benchmark/metrics/<name>.py``. All are found by name: a new cell, mix or
metric is new files and new manifest entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# the top-level module names that no run may hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "timetuning_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc), so that set-up
    counts the interpreter's own start and every import. Raises where /proc
    cannot be read: set-up has no other sound start."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout:
    only a checkout's first run builds. The port keeps its kernel library in
    ``timetuning_tpu_torch/_build/`` itself."""
    cache = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    # no library the port loads may pull in JAX on its own
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(names=None) -> list[str]:
    """Modules of JAX or of the JAX package among ``names`` (default
    ``sys.modules``), compared by whole top-level name
    (``timetuning_tpu_torch`` is not ``timetuning_tpu``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN_MODULES})


# --------------------------------------------------------------------- #
# the manifest and the files it names

@dataclasses.dataclass
class Cell:
    """One cell, with everything it names loaded."""

    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    dir: Path = HERE              # the benchmark's folder the cell was loaded from

    @property
    def name(self) -> str:
        return self.workload["name"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    bench = root / manifest["paths"][0]
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if m["moves"] in moved and _reports(m, name)]
    return Cell(w, config, traffic, e2e, layer, bench)


def load_module(path: Path, name: str):
    """A file of the benchmark as a module; metric files are named after
    metrics, whose dots a module name cannot hold."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(cell: Cell):
    entry = cell.traffic["entry"]
    return load_module(cell.dir / "drivers" / f"{entry}.py", f"driver_{entry}")


def load_limits(cell: Cell) -> dict:
    return load_json(cell.dir / "limits" / f"{cell.name}.json")["limits"]


def read_layer_metrics(cell: Cell, facts: dict) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        reader = load_module(cell.dir / "metrics" / f"{m['name']}.py", "metric_" + m["name"])
        value = reader.read(facts)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# --------------------------------------------------------------------- #
# the device

def card_facts(torch, count: int) -> dict:
    """The ``device`` object of the result line: the card's name, the cards
    used, the peak memory of the fullest, and the power limit (a card set
    below 700 W runs slower under load)."""
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak),
            "power_limit_w": power_limit_w()}


def power_limit_w() -> float | None:
    """The first card's power limit in W, or None where nvidia-smi gives
    none."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


# --------------------------------------------------------------------- #
# spans and the trace

class Spans:
    """Host-clock spans the benchmark records around its calls into the
    program, by name, and marked in a profiler trace when one runs."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.by_name: dict[str, list] = {}

    def span(self, name: str):
        import contextlib

        from torch.profiler import record_function

        @contextlib.contextmanager
        def cm():
            t0 = time.perf_counter()
            if self.traced:
                with record_function("bench." + name):
                    yield
            else:
                yield
            self.by_name.setdefault(name, []).append((t0, time.perf_counter()))
        return cm()

    def total_s(self, name: str, lo: float, hi: float) -> float:
        """Seconds of ``name``'s spans inside [lo, hi]."""
        return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in self.by_name.get(name, ()))

    def inside(self, name: str, lo: float, hi: float) -> list:
        return [(a, b) for a, b in self.by_name.get(name, ()) if a >= lo and b <= hi]


@dataclasses.dataclass
class Trace:
    """A profiler trace reduced to the window: device events (name,
    start_ns, end_ns, correlation id) and the harness's host spans (name,
    start_ns, end_ns) inside it."""

    lo: int
    hi: int
    device: list
    host: list

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    def busy_s(self) -> float:
        """The union of the device events' intervals."""
        busy, end = 0, self.lo
        for _, a, b, _ in sorted(self.device, key=lambda e: e[1]):
            busy += max(0, b - max(a, end))
            end = max(end, b)
        return busy / 1e9

    def by_kernel(self) -> dict:
        out: dict[str, float] = {}
        for name, a, b, _ in self.device:
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
        return out

    def idle_gaps(self, top: int = 10) -> list:
        """The longest stretches with no device event, each named by the
        host span that held the host at its middle (``host`` when none)."""
        gaps, end = [], self.lo
        for _, a, b, _ in sorted(self.device, key=lambda e: e[1]):
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.hi > end:
            gaps.append((end, self.hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = (a + b) / 2
            names = [n for n, s, e in self.host if s <= mid <= e]
            out.append([names[-1] if names else "host", (b - a) / 1e9])
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_kernel().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": self.idle_gaps(top)}

    def groups(self, patterns) -> dict:
        """Device time and event count of the kernels whose names hold one
        of ``patterns``, by the correlation id of their launch: one group a
        CUDA-graph replay or a launch."""
        out: dict = {}
        for name, a, b, corr in self.device:
            if any(p in name for p in patterns):
                n, t = out.get(corr, (0, 0.0))
                out[corr] = (n + 1, t + (b - a) / 1e9)
        return out


def reduce_profile(prof) -> Trace:
    """The device events and ``bench.*`` host spans of a ``torch.profiler``
    run inside its ``bench.window`` span."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == "bench.window"
           and e.device_type() == DeviceType.CPU]
    if not win:
        raise RuntimeError("the trace holds no bench.window span")
    lo, hi = win[0].start_ns(), win[0].end_ns()
    device, host = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            a, b = max(e.start_ns(), lo), min(e.end_ns(), hi)
            if b > a:
                device.append((e.name(), a, b, e.correlation_id()))
        elif e.name().startswith("bench.") and e.name() != "bench.window":
            host.append((e.name()[len("bench."):], e.start_ns(), e.end_ns()))
    return Trace(lo, hi, device, host)


def complete_share(groups: dict, least_s_per_group: float) -> float | None:
    """A roofline share over the groups (replays or launches) whose kernel
    events the trace kept whole: those with the most common event count,
    which a group that lost events falls short of. Both sides are summed
    over the same groups, so a lost event leaves out its group from both.
    None when the trace holds no such kernel."""
    if not groups:
        return None
    counts: dict[int, int] = {}
    for n, _ in groups.values():
        counts[n] = counts.get(n, 0) + 1
    full = max(counts, key=lambda n: (counts[n], n))
    kept = [t for n, t in groups.values() if n == full]
    return 100.0 * least_s_per_group * len(kept) / sum(kept)


# --------------------------------------------------------------------- #
# the result

def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q))


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown: dict | None = None) -> str:
    """The one JSON line of a run; the compared numbers under ``checks``,
    last, each with its limit."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def fact_line(facts: dict) -> str:
    """The run's plain facts (numbers and lists of numbers: the window, the
    steps or requests, the host spans' totals, each save), one line, for
    finding what moved a run; the trace is left out."""
    def plain(v):
        return (isinstance(v, (int, float)) and not isinstance(v, bool)) or (
            isinstance(v, list) and all(isinstance(x, (int, float)) for x in v))
    return "facts " + json.dumps({k: v for k, v in facts.items() if plain(v)})


def check_lines(checks: dict) -> str:
    return "\n".join(f"check {k}: {v['value']!r} limit {v['limit']!r} "
                     f"({'ok' if v['ok'] else 'FAILED'})" for k, v in checks.items())


def judge(numbers: dict, limits: dict) -> dict:
    """Each compared number beside its limit (a number passes at or under
    it)."""
    return {k: {"value": float(v), "limit": float(limits[k]),
                "ok": bool(v <= limits[k])} for k, v in numbers.items()}
