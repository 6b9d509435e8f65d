"""Readings for a cell's correctness limit: the program's number on many
seeds, and its controls' on the same requests, in one process.

    python3 h100bench/calibrate.py --workload sd15-serve-poisson --seeds 11,12,13 \
        --seconds 20 --controls fp8,program-fp8

For each seed it runs the cell once as run.py does (at the cell's own load,
for ``--seconds``), prints the program's compared number, then each
control's on the same sample: ``fp8``, the plain reference computed in
float8 e4m3 (its linears and convolutions), put in the program's place:
its images of the sampled requests take the place of the ones the timed
path returned and are judged against the fp32 reference by the run's own
checks and verdict (``fp8_correct``, which has to be false);
``program-fp8``, a witness, the cell run again with the port's own
weight-only e4m3 UNet (``io.quantize_tree``). The last line gives the
lower reading (the most the program read) and the upper reading (the
least the ``fp8`` control read).
"""
from __future__ import annotations

import argparse
import json
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def program_fp8(config):
    """The configuration module with the port's e4m3 weight-only UNet."""
    import torch

    from tinyfusers_tpu_torch.io.quantize_tree import quantize_params

    def build(cfg, seed, device):
        model = config.build(cfg, seed, device)
        quantize_params(model.unet, torch.float8_e4m3fn)
        return model

    attrs = {k: v for k, v in vars(config).items() if not k.startswith("__")}
    return types.SimpleNamespace(**dict(attrs, build=build))


def put_in_place(run, driver, prec: str) -> bool:
    """The reference computed in ``prec`` in the program's place: its
    images replace the sampled ones in ``run.compared``, the run's
    ``image_rms_levels`` is taken again against the fp32 reference, and
    the harness's verdict on the run's checks is returned."""
    from h100bench.lib import harness

    run.compared = driver.control(run, run.compared, prec)
    run.check("image_rms_levels", driver.compare(run, run.compared))
    return harness.is_correct(run.checks)


def main(argv=None, bench=None, roots=None) -> int:
    """bench, roots: a BENCHMARK dict and search roots in place of the
    checkout's (tests)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", default="fp8")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from h100bench.lib import harness

    controls = [c for c in args.controls.split(",") if c]
    lower, upper = 0.0, float("inf")
    for seed in (int(s) for s in args.seeds.split(",")):
        runs = []
        kw = {"bench": bench, "roots": roots or (harness.HERE,), "device": args.device}
        res = harness.run_workload(args.workload, seed, args.seconds, False, runs=runs, **kw)
        run = runs[0]
        driver = harness.load_module(
            harness.find(kw["roots"], f"drivers/{run.traffic['driver']}.py"))
        row = {"seed": seed, "correct": res["correct"], "metrics": res["metrics"],
               "program": res["checks"]["image_rms_levels"]["value"]}
        lower = max(lower, row["program"])
        for c in controls:
            if c == "fp8":
                row["fp8_correct"] = put_in_place(run, driver, "fp8")
                row[c] = run.checks["image_rms_levels"]["value"]
                upper = min(upper, row[c])
            elif c == "program-fp8":
                qres = harness.run_workload(args.workload, seed, args.seconds, False,
                                            wrap_config=program_fp8, **kw)
                row[c] = qres["checks"]["image_rms_levels"]["value"]
                row["program-fp8_correct"] = qres["correct"]
            else:
                raise ValueError(f"unknown control {c!r}")
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
