"""What the program's span recording costs on the card's host, with it on
against off, in one process.

    python3 h100bench/spans_cost.py --seed 4200000011

From the root of a checkout, on a machine with a CUDA device. Three
readings, each printed on a line of its own:

- ``[span-ns]``: the host time of one ``profiling.span()`` block and of
  one request span's ``begin()`` / ``end()``, off and on (the best of 5
  timeit repeats of 200,000 each), and of an empty call;
- ``[tick-ab]``: the serve cell's engine (its configuration, 8 slots) with
  every slot busy and no admission or decode in the tick: adjacent ticks
  with tracing on and off in turn, the order swapped every pair; the
  medians of each side and the per-pair on / off ratio's median,
  quartiles (``statistics.quantiles``) and mean;
- ``[gen-ab]``: the SD3 cell's ``generate`` call, the same way, in pairs.

Tracing is turned on around the timed tick or call alone, and the spans
are drained after it, outside the time.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def span_ns(n: int = 200_000) -> dict:
    """ns of a span block and of a request span's begin / end, off and on."""
    from tinyfusers_tpu_torch.utils import profiling as p

    scope = object()

    def one():
        with p.span("engine.tick"):
            pass

    def req():
        p.begin("request.queued", 1, scope)
        p.end("request.queued", 1, scope)

    def best(fn):
        return min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e9

    out = {"span_off": best(one), "request_off": best(req), "empty_call": best(lambda: None)}
    with p.tracing():
        out["span_on"] = best(one)
        p.drain()
        out["request_on"] = best(req)
        p.drain()
    return out


def _paired(timed, pairs: int):
    """(off seconds, on seconds, on / off of each pair) of ``timed()`` run
    with tracing off and on in turn: off first in even pairs, on first in
    odd ones."""
    from tinyfusers_tpu_torch.utils import profiling

    off, on, ratios = [], [], []
    for k in range(pairs):
        pair = {}
        for side in ((False, True) if k % 2 == 0 else (True, False)):
            with profiling.tracing() if side else contextlib.nullcontext():
                pair[side] = timed()
            profiling.drain()
        off.append(pair[False])
        on.append(pair[True])
        ratios.append(pair[True] / pair[False])
    return off, on, ratios


def _summary(off, on, ratios, scale: float, unit: str) -> str:
    q = statistics.quantiles(ratios, n=4)
    return (f"off median {scale * statistics.median(off):.4f} {unit}, on median "
            f"{scale * statistics.median(on):.4f} {unit}; on/off per pair median "
            f"{statistics.median(ratios):.5f} (quartiles {q[0]:.5f} {q[2]:.5f}), mean "
            f"{statistics.fmean(ratios):.5f}")


def tick_ab(bench: dict, seed: int, rounds: int, steps: int = 50) -> str:
    """Adjacent ticks that only step the 8 slots, on against off."""
    import torch

    from h100bench.lib import harness
    from h100bench.lib.inputs import prompt, rng_for
    from tinyfusers_tpu_torch.serve import Engine

    _, cfg, config, T, _, _ = harness.load_cell("sd15-serve-poisson", [harness.HERE], bench)
    model = config.build(cfg, seed, "cuda")
    S = T["num_slots"]
    eng = Engine(model, num_slots=S)
    length, vocab = cfg["clip"]["max_length"], cfg["clip"]["vocab_size"]
    rng, uncond = rng_for(seed, 5), prompt(None, 0, length, vocab)

    def tick():
        t = time.perf_counter()
        eng.step()
        return time.perf_counter() - t

    off, on, ratios = [], [], []
    for r in range(rounds + 1):  # the first round warms up
        for _ in range(S):
            eng.submit(eng.make_request(prompt(rng, 30, length, vocab), uncond, num_steps=steps,
                                        guidance=T["guidance"],
                                        seed=int(rng.integers(0, 2 ** 62))))
        eng.step()  # admits every slot
        eng.step()
        torch.cuda.synchronize()
        got = _paired(tick, (steps - 4) // 2)  # every slot still steps in each
        if r:
            for acc, more in zip((off, on, ratios), got):
                acc.extend(more)
        eng.run_until_idle()
    del eng, model
    torch.cuda.empty_cache()
    return (f"[tick-ab] {len(ratios)} pairs of slot-step-only ticks, {S} slots: "
            + _summary(off, on, ratios, 1e3, "ms"))


def gen_ab(bench: dict, seed: int, pairs: int) -> str:
    """The SD3 cell's generate call, on against off."""
    import torch

    from h100bench.drivers import generate_closed_loop as drv
    from h100bench.lib import harness
    from tinyfusers_tpu_torch.pipeline import sd3

    _, cfg, config, T, _, _ = harness.load_cell("sd3-medium-b1", [harness.HERE], bench)
    model = config.build(cfg, seed, "cuda")
    ids, uids, lat, _ = next(drv.requests(T, cfg, config.latent_hw(cfg), seed, "cuda"))

    def call():
        t = time.perf_counter()
        sd3.generate(model, ids, ids, uids, uids, lat, T["guidance"], num_steps=T["steps"],
                     method=T["sampler"]).cpu()
        return time.perf_counter() - t

    call()
    off, on, ratios = _paired(call, pairs)
    del model
    torch.cuda.empty_cache()
    return f"[gen-ab] {pairs} pairs of calls: " + _summary(off, on, ratios, 1.0, "s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--tick-rounds", type=int, default=4)
    ap.add_argument("--gen-pairs", type=int, default=8)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from h100bench.run import power_limit

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    print(f"{torch.cuda.get_device_name(0)}, power limit {power_limit()}", flush=True)
    ns = span_ns()
    print("[span-ns] " + ", ".join(f"{k} {v:.1f} ns" for k, v in ns.items()), flush=True)
    print(tick_ab(bench, args.seed, args.tick_rounds), flush=True)
    print(gen_ab(bench, args.seed, args.gen_pairs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
