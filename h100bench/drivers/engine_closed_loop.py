"""Closed-loop serving through the port's continuous-batching engine
(``tinyfusers_tpu_torch.serve.Engine``), for configurations with an SD
UNet: a fixed number of clients, each of which submits its next request
the moment its previous image is back, with no think time. With more
clients than slots the engine runs saturated and its queue never
empties: the cell judges the images it finishes a second.

Traffic (traffic/<name>.json): ``num_slots``, ``clients``, ``steps``
(the step counts: every run of len(steps) consecutive requests holds
each once, in an order from the seed), ``guidance``, ``prompt_tokens``
[lo, hi], ``drain_s``, ``sample`` (requests compared with the
reference), ``profile_after`` (the share of the window that the host
metric reads; the traced slice comes after it), ``profile_ticks`` and
``profile_min_active`` (the traced slice: the first ``profile_ticks``
consecutive ticks after ``profile_after`` of the window that each step
at least ``profile_min_active`` slots). Request k, the k-th submitted,
is the same for a seed however the clients interleave: its step count,
its prompt (start token, random ids, end-of-text to 77) and its noise
seed. The warm-up, the sample, the reference and the comparison are
engine_open_loop.py's.

``images_per_s``: the images back inside the window, plus for each
client the share of its request in flight at the close (submit to
return) that lay inside the window, over the window. Nothing is
submitted after the close; the run waits at most ``drain_s`` for the
requests in flight, and one that does not come back counts as failed.

The per-layer metrics that read ``run.trace`` (the slice) read it as in
the open loop; ``run.records["calls"]``, read by ``mfu.gen``, holds each
tick of the window's first ``profile_after`` share that stepped slots,
with the analytic FLOPs of its useful work (a UNet pass on the two CFG
rows of every active slot, each decode issued).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from h100bench.drivers.engine_open_loop import compare, control, sample, warm_up  # noqa: F401
from h100bench.lib import harness, roofline
from h100bench.lib.inputs import prompt, rng_for
from h100bench.lib.trace import Slice, warm_profiler


def requests(traffic, seed: int, length: int, vocab: int):
    """Endless (steps, prompt ids, request seed), the k-th the same for a
    seed however many are drawn."""
    rng = rng_for(seed, 1)
    lo, hi = traffic["prompt_tokens"]
    while True:
        for steps in rng.permutation(np.asarray(traffic["steps"])):
            ids = prompt(rng, int(rng.integers(lo, hi + 1)), length, vocab)
            yield int(steps), ids, int(rng.integers(0, 2 ** 62))


def rate(submit_t: dict, done_t: dict, end: float, seconds: float, t_drained: float) -> float:
    """images_per_s of a window ending at ``end``: request id -> submit
    time and -> return time (a request not back counts as back at
    ``t_drained``)."""
    whole, part = 0, 0.0
    for rid, t_s in submit_t.items():
        t_r = done_t.get(rid, t_drained)
        if t_r <= end:
            whole += 1
        elif t_s < end:
            part += (end - t_s) / (t_r - t_s)
    return (whole + part) / seconds


def serve(eng, draw, T, uncond, t0: float, seconds: float, *, trace: bool = False,
          on_close=None, new_slice=None) -> dict:
    """Run the clients from t0 for ``seconds``, then drain; what happened."""
    S, g = T["num_slots"], T["guidance"]
    end = t0 + seconds
    after, need = T["profile_after"] * seconds, T["profile_min_active"]
    new_slice = new_slice or (lambda: Slice(counters=roofline.counter_launches))
    sched, rid_at, submit_t, done_t, images = [], {}, {}, {}, {}
    ticks, sl, kept, sl_work, dropped = [], None, None, [], 0

    def submit():
        steps, ids, rseed = next(draw)
        t = time.perf_counter()
        with torch.profiler.record_function("bench:submit"):
            rid = eng.submit(eng.make_request(ids, uncond, num_steps=steps, guidance=g,
                                              seed=rseed))
        rid_at[rid], submit_t[rid] = len(sched), t
        sched.append((t - t0, steps, ids, rseed))

    def take(results, t) -> int:
        for r in results:
            done_t[r.request_id] = t
            images[r.request_id] = r.image
        return len(results)

    for _ in range(T["clients"]):
        submit()
    closed = False
    while True:
        now = time.perf_counter()
        if not closed and now >= end:
            closed = True
            if on_close is not None:
                on_close()
        if closed and (len(done_t) == len(rid_at) or now >= end + T["drain_s"]):
            break
        active, pending = eng.core.active(), eng.core.pending()
        if active == 0 and pending == 0:  # decodes in flight: hand them out as they land
            back = take(eng.step(), time.perf_counter())
            for _ in range(0 if closed else back):
                submit()
            time.sleep(0.0005)
            continue
        act = min(S, active + pending)
        if sl is not None and act < need:
            sl.stop()
            sl, dropped = None, dropped + 1
        if (trace and kept is None and sl is None and not closed and now - t0 >= after
                and act >= need):
            sl, sl_work = new_slice(), []
            sl.start()
        t_a = time.perf_counter()
        with torch.profiler.record_function("bench:tick"):
            results = eng.step()
        t_b = time.perf_counter()
        decodes = act - eng.core.active()
        back = take(results, t_b)
        ticks.append({"s": t_b - t_a, "active": act, "pending": pending, "decodes": decodes,
                      "in_window": not closed, "t": t_b - t0})
        if sl is not None:
            sl_work.append((act, decodes))
            if len(sl_work) == T["profile_ticks"]:
                sl.stop()
                kept, sl = sl, None
        for _ in range(0 if closed else back):
            submit()
    if sl is not None:
        sl.stop()
        dropped += 1
    take(eng.flush(), time.perf_counter())
    t_drained = time.perf_counter()
    return {"end": end, "sched": sched, "rid_at": rid_at, "submit_t": submit_t,
            "done_t": done_t, "images": images, "ticks": ticks, "t_drained": t_drained,
            "slice": kept, "slice_work": sl_work if kept is not None else [],
            "dropped": dropped}


def run(run) -> None:
    from tinyfusers_tpu_torch.serve import Engine

    T, cfg, dev = run.traffic, run.cfg, run.device
    cuda = torch.device(dev).type == "cuda"
    length, vocab = cfg["clip"]["max_length"], cfg["clip"]["vocab_size"]
    uncond = prompt(None, 0, length, vocab)
    S = T["num_slots"]

    model = run.config.build(cfg, run.seed, dev)
    eng = Engine(model, num_slots=S)
    harness.log(f"[setup] engine {S} slots, core {type(eng.core).__name__}, "
                f"{T['clients']} closed-loop clients over {run.seconds} s")
    warm_up(eng, T, run.seed, length, vocab)
    if run.trace_on and cuda:
        warm_profiler()

    t0 = run.begin_window()
    out = serve(eng, requests(T, run.seed, length, vocab), T, uncond, t0, run.seconds,
                trace=run.trace_on and cuda, on_close=run.read_peak_memory)
    done_t, n = out["done_t"], len(out["rid_at"])
    run.attempted, run.failed = n, n - len(done_t)
    run.e2e["images_per_s"] = rate(out["submit_t"], done_t, out["end"], run.seconds,
                                   out["t_drained"])
    run.e2e["peak_mem_gib"] = run.memory_peak / 2 ** 30
    lat = [done_t[r] - out["submit_t"][r] for r in done_t]
    inside = [t for t in out["ticks"] if t["in_window"]]
    harness.log(f"[serve] {sum(t <= out['end'] for t in done_t.values())} images back by the "
                f"close; submitted {n}, succeeded {len(done_t)}, failed {run.failed}; "
                f"{run.e2e['images_per_s']:.4f} images/s; submit to return p50 "
                f"{np.percentile(lat, 50):.4f} s p90 {np.percentile(lat, 90):.4f} s; "
                f"{len(inside)} ticks in the window, mean "
                f"{1e3 * np.mean([t['s'] for t in inside]):.2f} ms, mean queue "
                f"{np.mean([t['pending'] for t in inside]):.2f}")
    den = run.config.work(cfg, "denoise", 2)[0]
    dec = run.config.work(cfg, "decode", 1)[0]
    run.records["ticks"] = [t for t in out["ticks"] if t["t"] <= T["profile_after"] * run.seconds]
    run.records["calls"] = [{"s": t["s"], "images": t["decodes"],
                             "flops": t["active"] * den + t["decodes"] * dec}
                            for t in run.records["ticks"] if t["active"]]
    if out["slice"] is not None:
        run.trace = out["slice"].summary()
        run.trace["ticks"] = len(out["slice_work"])
        step_calls = run.config.work(cfg, "denoise", 2 * S)[1]
        dec_calls = run.config.work(cfg, "decode", 1)[1]
        run.trace_calls = [c for _, d in out["slice_work"] for c in step_calls + dec_calls * d]
        run.trace["counter_launches"] = out["slice"].counts
        harness.log(f"[trace] {run.trace['ticks']} ticks, {run.trace['launches']} kernels, busy "
                    f"{run.trace['busy_s']:.4f} of {run.trace['window_s']:.4f} s; "
                    f"{roofline.cross_check(run)}; {out['dropped']} slice(s) dropped")
    elif run.trace_on and cuda:
        harness.log(f"[trace] no {T['profile_ticks']} consecutive ticks each stepping "
                    f"{T['profile_min_active']} slots or more after {T['profile_after']} of the "
                    f"window ({out['dropped']} slice(s) dropped): no device-side per-layer metric")

    del eng, model
    if cuda:
        torch.cuda.empty_cache()
    run.check("unanswered", run.failed, 0)
    run.compared = sample(run, out["sched"], out)
    run.check("image_rms_levels", compare(run, run.compared))
