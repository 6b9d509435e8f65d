"""The benchmark at TINY sizes on the CPU: a BENCHMARK dict with a serve
cell and a generate cell of its own, and a search root in a temporary
directory holding their traffic and limits, beside h100bench/'s files."""
from __future__ import annotations

import copy
import json
from pathlib import Path

from h100bench.lib import harness

HERE = Path(__file__).resolve().parent
SERVE, GEN = "tiny-serve", "tiny-gen"


# The tiny cells' limit, set as the cells' own are: the fp32 program on the
# CPU reads 0.02-0.03 levels against the reference at these sizes, the
# fp8 control in its place 11-25 and the faults of
# test_h100bench_faults.py 66-145.
LIMIT = {"image_rms_levels": 1.0}


def bench_and_roots(tmp: Path):
    bench = copy.deepcopy(json.loads((harness.ROOT / "BENCHMARK.json").read_text()))
    bench["configs"] += [
        {"name": "tiny-sd", "source": "tests", "file": str(HERE / "tiny_sd.json"), "reduced": [],
         "why": "tests"},
        {"name": "tiny-sd3", "source": "tests", "file": str(HERE / "tiny_sd3.json"),
         "reduced": [], "why": "tests"}]
    for d in ("traffic", "limits"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    serve = json.loads((harness.HERE / "traffic/poisson-8slot.json").read_text())
    serve.update(rate_per_s=4.0, steps=[2, 3, 4], num_slots=4, profile_min_active=2,
                 profile_ticks=2, profile_after=0.3, sample=3, prompt_tokens=[2, 10], drain_s=30)
    gen = json.loads((harness.HERE / "traffic/closed-b1.json").read_text())
    gen.update(steps=3, prompt_tokens=[1, 5])
    (tmp / "traffic" / f"{SERVE}.json").write_text(json.dumps(serve))
    (tmp / "traffic" / f"{GEN}.json").write_text(json.dumps(gen))
    for w, c in ((SERVE, "tiny-sd"), (GEN, "tiny-sd3")):
        (tmp / "limits" / f"{w}.json").write_text(json.dumps(LIMIT))
        bench["workloads"].append({"name": w, "config": c, "traffic": w, "chips": 1,
                                   "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(SERVE if "sd15-serve-poisson" in m["workloads"] else GEN)
    return bench, [tmp, harness.HERE]
