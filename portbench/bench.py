"""One run of one cell: set-up, the measured window, the check.

Everything a cell needs is found by name. ``BENCHMARK.json`` names the
cell's configuration (``configs/<name>.json``: the graph, the index
settings, the check's size) and its traffic (``traffic/<name>.json``:
its ``kind`` and parameters). Each metric is
read by ``metrics/<name>.py``, whose ``read(run)`` takes the run's
record and returns a number, or None where the run holds nothing to
read; a run in which a metric its cell lists has nothing to read exits
nonzero and prints no result.

A traffic file's ``kind`` names ``kinds/<kind>.py``, whose ``run(ctx)``
does the set-up and the window and returns the record and the pairs to
check; configurations name ``generators/<name>.py`` for their graph.

The window runs whole requests or builds: it starts at the first and
ends when the last one that started before ``seconds`` had passed has
finished. The check compares what the window produced with the plain
reference (``reference.py``) once the window has closed, the peak
memory has been read and the program's state is freed.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from portbench.named import load

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# streams drawn from one seed
TRAFFIC, WARMUP, CHECK, WEIGHTS = range(4)


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, *stream])


def endpoints(graph):
    """``pick(draw, b)``: b pairs (s, t) drawn uniformly by ``draw``
    over the vertices of ``graph`` that have an edge."""
    n, src = graph[0], graph[1]
    have = np.flatnonzero(np.bincount(src, minlength=n)).astype(np.int32)

    def pick(draw: np.random.Generator, b: int):
        return (have[draw.integers(0, len(have), b)],
                have[draw.integers(0, len(have), b)])
    return pick


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(spec: dict, workload: str) -> tuple[dict, dict, dict]:
    """The cell named ``workload``, its configuration and its traffic."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def metrics_of(spec: dict, cell: dict, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or
    with ``trace`` its per-layer ones."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if cell["name"] in m.get("workloads", [cell["name"]])]


def reader(name: str):
    """``read`` of ``metrics/<name>.py``."""
    return load("metrics", name, "read")


def forbidden_modules(names=None) -> list[str]:
    """The top-level names among ``names`` (the loaded modules by
    default) that are JAX's or the JAX package's, compared whole:
    ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


# ------------------------------------------------------------------ window
class Window:
    """The measured window, traced or not. With ``trace`` the whole
    window runs under ``torch.profiler`` and the harness's ranges are
    recorded; without it ``span`` costs nothing."""

    def __init__(self, trace: bool, device: str):
        self.trace = trace
        self.device = device
        self.prof = None
        self.first_stage2 = None

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.trace:
            yield
            return
        from torch.profiler import record_function
        with record_function(name):
            yield

    def _keep_first(self, args, out):
        if self.first_stage2 is None:
            self.first_stage2 = (args, out)

    @contextlib.contextmanager
    def open(self):
        if not self.trace:
            yield self
            return
        from torch.profiler import ProfilerActivity, profile
        from portbench.timeline import wrap_stage2
        acts = [ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof, wrap_stage2(self._keep_first):
            with self.span("window"):
                yield self
            sync(self.device)
        self.prof = prof

    def analyse(self) -> dict:
        from portbench import timeline
        events = timeline.events_of(self.prof)
        self.prof = None
        spans = [(e["start"], e["end"]) for e in events
                 if e["annotation"] and not e["device"]
                 and e["name"] == "window"]
        lo, hi = spans[0]
        return timeline.analyse(events, lo, hi)


def sync(device: str):
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


# ------------------------------------------------------------------ kinds
def index_config(config: dict):
    from repro_torch.core import IndexConfig
    return IndexConfig(**config["index"])


def setup_parts(ctx: dict, t_built: float, t_ready: float) -> dict:
    """Set-up's seconds by part: to the harness's start (the interpreter,
    imports, the CUDA context), the graph, the index build, the
    warm-up."""
    t0, t1, t2 = ctx["t_start"], ctx["t_begin"], ctx["t_graph"]
    return {"start_s": t1 - t0, "graph_s": t2 - t1, "build_s": t_built - t2,
            "warmup_s": t_ready - t_built}


# ------------------------------------------------------------------ a run
def stage2_work(first, idx, device) -> dict:
    """The stage-2 work of the window's first request (``work.replay``
    from the seeds its ``CoreRelaxer.run`` received) beside that call's
    own frontiers and rounds."""
    from portbench import work
    from repro_torch.core.sync import host_read
    args, out = first
    seeds_s, seeds_t = args[0], args[1]
    pos = idx.core_pos_host
    rep = work.replay(seeds_s, seeds_t, pos[idx.core_src], pos[idx.core_dst],
                      idx.core_w, idx.stats.n_core, device,
                      frontiers=(out[1], out[2]))
    rep["program_rounds"] = int(host_read(out[3]))
    rep["bound_s"], rep["bound_by"] = work.bound_s(rep["bytes"], rep["ops"])
    return rep


def power_limit() -> str | None:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else None


def run_cell(cell: dict, config: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device: str, t_start: float,
             metrics: list[dict]) -> tuple[dict, list[str]]:
    """One run. Returns the result line's object and the check lines."""
    import torch
    from portbench import reference
    from portbench.graphs import make_graph
    if device == "cuda":
        torch.cuda.init()
    t_begin = time.perf_counter()
    ctx = {"cell": cell, "config": config, "traffic": traffic, "seed": seed,
           "seconds": seconds, "trace": trace, "device": device,
           "t_start": t_start, "t_begin": t_begin,
           "graph": make_graph(config["graph"])}
    ctx["t_graph"] = time.perf_counter()
    out = load("kinds", traffic["kind"], "run")(ctx)
    run, window, idx = out["run"], out["window"], out.pop("index")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if trace:
        run["trace"] = window.analyse()
        if window.first_stage2 is not None:
            run["work"] = stage2_work(window.first_stage2, idx, device)
    window.first_stage2 = None
    del idx, out["window"], window
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    n = ctx["graph"][0]
    w, s, t, got, due = out["check"]
    want = reference.pair_distances(n, ctx["graph"][1], ctx["graph"][2], w,
                                    s, t, device)
    mismatched = int((~(want == got)).sum())
    checks = {"mismatched_pairs": {"value": mismatched, "max": 0},
              "checked_pairs": {"value": int(len(got)), "min": int(due)}}
    correct = mismatched == 0 and len(got) >= due

    values = {}
    for m in metrics:
        v = reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    n_work = run.get("requests", len(run.get("builds", [])))
    dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                         else "cpu"),
                "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": n_work, "failed": 0,
              "metrics": values, "device": dev_info}
    info = {k: v for k, v in run.items()
            if k not in ("latencies_s", "builds", "trace")}
    if trace:
        tr = run["trace"]
        dev_info["busy_s"] = tr["busy_s"]
        dev_info["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in
                                              tr["device_ops"][:10]],
                               "idle_gaps": [list(x) for x in
                                             tr["idle_gaps"][:10]]}
        info["device_events"] = tr["device_events"]
        info["unlinked"] = tr["unlinked"]
    if device == "cuda":
        info["card"] = power_limit()
    result["run"] = info
    result["checks"] = checks
    lines = [f"check {k} {v['value']} "
             + ("<= " + str(v["max"]) if "max" in v else ">= " + str(v["min"]))
             for k, v in checks.items()]
    return result, lines


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: src/repro_torch is not in this checkout",
              file=sys.stderr)
        return 2
    spec = load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic = resolve(spec, args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, lines = run_cell(cell, config, traffic, args.seed, args.seconds,
                             bool(args.trace), "cuda", t_start,
                             metrics_of(spec, cell, bool(args.trace)))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 4
    missing = [m["name"] for m in metrics_of(spec, cell, bool(args.trace))
               if m["name"] not in result["metrics"]]
    if missing:
        print(f"portbench: {args.workload} lists {missing}, but the run "
              f"holds nothing to read for them: no result", file=sys.stderr)
        return 5
    print(json.dumps(result))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0
