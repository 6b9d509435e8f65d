"""The harness behind run.py: find a cell's files by name, drive it, read
its metrics and assemble the result line.

A cell (an entry of BENCHMARK.json's ``workloads``) names a configuration
and a traffic mix. Everything that belongs to one of them sits in files of
its own, found by name under the search roots (h100bench/ first, unless a
caller puts others before it):

- the configuration: its ``file`` from BENCHMARK.json (sizes), and the
  model builder beside it with the suffix ``.py`` (or the file its
  ``builder`` key names, relative to it);
- the traffic mix: ``traffic/<traffic>.json``, whose ``driver`` names
  ``drivers/<driver>.py``;
- the correctness limits of the cell: ``limits/<workload>.json``;
- each per-layer metric: ``metrics/<name>.py``, whose ``read(run)`` returns
  the value or None when the run has nothing for it to read.

A driver's ``run(run)`` builds the program, warms it up, calls
``run.begin_window()``, drives the window, fills ``run.e2e``,
``run.records`` and, in a traced run, ``run.trace`` and ``run.trace_calls``,
then frees the program and fills ``run.checks`` from the reference.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

HERE = Path(__file__).resolve().parent.parent      # h100bench/
ROOT = HERE.parent                                  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "tinyfusers_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"h100bench_file_{abs(hash(str(path)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find(roots: Sequence[Path], rel: str) -> Path:
    for r in roots:
        if (Path(r) / rel).is_file():
            return Path(r) / rel
    raise FileNotFoundError(f"{rel} under none of {[str(r) for r in roots]}")


def is_correct(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every compared number within its limit, and at least one compared."""
    return bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (tinyfusers_tpu_torch passes)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """One run of one cell: what the driver reads and what it leaves."""

    def __init__(self, *, cfg: Dict, config, traffic: Dict, limits: Dict, seed: int,
                 seconds: float, trace: bool, device: str, t_start: float):
        self.cfg, self.config = cfg, config
        self.traffic, self.limits = traffic, limits
        self.seed, self.seconds, self.trace_on, self.device = seed, seconds, trace, device
        self.t_start = t_start
        self.setup_s: Optional[float] = None
        self.e2e: Dict[str, float] = {}
        self.records: Dict = {}
        self.trace: Optional[Dict] = None
        self.trace_calls: List = []
        self.checks: Dict[str, Dict[str, float]] = {}
        self.attempted = self.failed = 0
        self.memory_peak = 0
        self.peak = None
        if torch.device(device).type == "cuda":
            from . import roofline

            self.peak = roofline.peaks(torch.cuda.get_device_name(0))

    def begin_window(self) -> float:
        """Set-up ends here: the device is idle, its peak memory reset."""
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.setup_s = time.time() - self.t_start
        return time.perf_counter()

    def read_peak_memory(self) -> int:
        if torch.device(self.device).type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated()
        return self.memory_peak

    def check(self, name: str, value: float, limit: Optional[float] = None) -> None:
        """A compared number, held to limits/<workload>.json (or ``limit``):
        correct where value <= limit."""
        lim = self.limits[name] if limit is None else limit
        self.checks[name] = {"value": value, "limit": lim}


def load_cell(name: str, roots: Sequence[Path], bench: Dict):
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == workload["config"])
    cfg_path = Path(conf["file"])
    cfg_path = cfg_path if cfg_path.is_absolute() else ROOT / cfg_path
    cfg = json.loads(cfg_path.read_text())
    config = load_module(cfg_path.parent / cfg.get("builder", cfg_path.with_suffix(".py").name))
    traffic = json.loads(find(roots, f"traffic/{workload['traffic']}.json").read_text())
    driver = load_module(find(roots, f"drivers/{traffic['driver']}.py"))
    limits = json.loads(find(roots, f"limits/{name}.json").read_text())
    return workload, cfg, config, traffic, driver, limits


def run_workload(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
                 bench: Optional[Dict] = None, roots: Sequence[Path] = (HERE,),
                 t_start: Optional[float] = None, wrap_config=None, runs: Optional[list] = None
                 ) -> Dict:
    """Drive one cell once; the result line's dict. wrap_config(module)
    gives the configuration module to use in place of the cell's (a
    control run's); ``runs``, if given, receives the Run."""
    t_start = time.time() if t_start is None else t_start
    bench = json.loads((ROOT / "BENCHMARK.json").read_text()) if bench is None else bench
    workload, cfg, config, traffic, driver, limits = load_cell(name, roots, bench)
    if wrap_config is not None:
        config = wrap_config(config)
    run = Run(cfg=cfg, config=config, traffic=traffic, limits=limits, seed=seed,
              seconds=seconds, trace=trace, device=device, t_start=t_start)
    driver.run(run)
    run.e2e["setup_s"] = run.setup_s
    metrics = {}
    if not trace:
        for m in bench["end_to_end"]:
            if applies(m, name):
                metrics[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if applies(m, name):
                value = load_module(find(roots, f"metrics/{m['name']}.py")).read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": workload["chips"], "memory_peak_bytes": run.memory_peak}
    result = {"correct": is_correct(run.checks), "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = run.trace["breakdown"]
    result["checks"] = run.checks
    if runs is not None:
        runs.append(run)
    return result
