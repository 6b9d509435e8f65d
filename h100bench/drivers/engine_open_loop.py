"""Open-loop serving through the port's continuous-batching engine
(``tinyfusers_tpu_torch.serve.Engine``), for configurations with an SD
UNet.

Traffic (traffic/<name>.json): ``num_slots``, ``rate_per_s``, ``steps``
(the step counts, drawn in equal shares), ``guidance``, ``prompt_tokens``
[lo, hi], ``drain_s``, ``sample`` (requests compared with the reference),
``profile_after`` (the share of the window that the host-side per-layer
metrics read; the traced slice comes after it), ``profile_ticks`` and
``profile_min_active`` (the traced slice: the first ``profile_ticks``
consecutive ticks after ``profile_after`` of the window that each step at
least ``profile_min_active`` slots).

The schedule is fixed by the rate and the window: n = round(rate *
seconds) requests whose gaps are the n exponential quantiles of mean
1 / rate (stratified, not independent draws), so every seed offers the
same amount of work in the same window; the seed orders the gaps, the
step counts and the prompt lengths, and draws the token ids and each
request's noise seed. A prompt is the start token, its random ids, then
end-of-text to 77; the negative prompt is the start token and
end-of-text padding.

The loop submits each request when it is due, even when the engine is
busy, and steps the engine; each request's latency runs from when it was
due to when its image came back. After the window nothing more is sent
and the run waits at most ``drain_s`` for the requests in flight; one
that does not come back counts as failed, with the time waited.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from h100bench.lib import harness, roofline
from h100bench.lib.inputs import prompt, rng_for
from h100bench.lib.trace import Slice, warm_profiler


def schedule(traffic, seed: int, seconds: float, length: int, vocab: int):
    """[(due offset s, steps, prompt ids, request seed)], sorted by due."""
    rate = traffic["rate_per_s"]
    n = max(1, round(rate * seconds))
    rng = rng_for(seed, 1)
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    gaps = rng.permutation(gaps * (n / rate) / gaps.sum())
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    steps = rng.permutation(np.resize(np.asarray(traffic["steps"]), n))
    lo, hi = traffic["prompt_tokens"]
    lens = rng.permutation(np.rint(np.linspace(lo, hi, n)).astype(int))
    seeds = rng.integers(0, 2 ** 62, size=n)
    return [(float(due[i]), int(steps[i]), prompt(rng, int(lens[i]), length, vocab),
             int(seeds[i])) for i in range(n)]


def warm_up(eng, T, seed: int, length: int, vocab: int) -> None:
    """One request of each step count of the mix, run to the end."""
    rng, uncond = rng_for(seed, 2), prompt(None, 0, length, vocab)
    for steps in T["steps"]:
        eng.submit(eng.make_request(prompt(rng, 8, length, vocab), uncond, num_steps=steps,
                                    guidance=T["guidance"], seed=int(rng.integers(0, 2 ** 62))))
    eng.run_until_idle()


def serve(eng, sched, T, uncond, t0: float, seconds: float, *, trace: bool = False,
          on_close=None, new_slice=None) -> dict:
    """Offer ``sched`` from t0 for ``seconds``, then drain; what happened.
    A traced run profiles the first ``profile_ticks`` consecutive ticks
    after ``profile_after`` of the window that each step at least
    ``profile_min_active`` slots: a slice that meets a tick stepping fewer
    is dropped before that tick, and the next tick that steps enough starts
    another. ``new_slice()`` makes a slice (a profiler over the device)."""
    S, g = T["num_slots"], T["guidance"]
    end, n = t0 + seconds, len(sched)
    due = [t0 + s[0] for s in sched]
    after, need = T["profile_after"] * seconds, T["profile_min_active"]
    new_slice = new_slice or (lambda: Slice(counters=roofline.counter_launches))
    rid_at, late, done_t, images = {}, [], {}, {}
    ticks, sl, kept, sl_work, dropped = [], None, None, [], 0
    i, closed = 0, False

    def take(results, t):
        for r in results:
            done_t[r.request_id] = t
            images[r.request_id] = r.image

    while True:
        now = time.perf_counter()
        while i < n and due[i] <= now:  # every due lies inside the window
            _, steps, ids, rseed = sched[i]
            with torch.profiler.record_function("bench:submit"):
                rid = eng.submit(eng.make_request(ids, uncond, num_steps=steps, guidance=g,
                                                  seed=rseed))
            rid_at[rid] = i
            late.append(time.perf_counter() - due[i])
            i += 1
        if not closed and now >= end:
            closed = True
            if on_close is not None:
                on_close()
        if closed and (len(done_t) == n or now >= end + T["drain_s"]):
            break
        active, pending = eng.core.active(), eng.core.pending()
        if active == 0 and pending == 0:
            if len(done_t) < i:  # decodes in flight: hand them out as they land
                take(eng.step(), time.perf_counter())
                time.sleep(0.0005)
            else:
                wake = due[i] if i < n else end
                time.sleep(max(0.0, min(wake, end) - now))
            continue
        act = min(S, active + pending)  # the free slots admit the queue's head
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
        take(results, t_b)
        ticks.append({"s": t_b - t_a, "active": act, "pending": pending, "decodes": decodes,
                      "in_window": not closed, "t": t_b - t0})
        if sl is not None:
            sl_work.append((act, decodes))
            if len(sl_work) == T["profile_ticks"]:
                sl.stop()
                kept, sl = sl, None
    if sl is not None:  # the run ended inside a slice
        sl.stop()
        dropped += 1
    take(eng.flush(), time.perf_counter())
    t_drained = time.perf_counter()
    lat = [done_t[r] - due[k] if r in done_t else t_drained - due[k] for r, k in rid_at.items()]
    lat += [t_drained - due[k] for k in range(i, n)]  # never sent
    return {"sent": i, "n": n, "end": end, "done_t": done_t, "images": images, "rid_at": rid_at,
            "late": late, "lat": lat, "ticks": ticks,
            "slice": kept, "slice_work": sl_work if kept is not None else [], "dropped": dropped}


def run(run) -> None:
    from tinyfusers_tpu_torch.serve import Engine

    T, cfg, dev = run.traffic, run.cfg, run.device
    cuda = torch.device(dev).type == "cuda"
    length, vocab = cfg["clip"]["max_length"], cfg["clip"]["vocab_size"]
    uncond = prompt(None, 0, length, vocab)
    sched = schedule(T, run.seed, run.seconds, length, vocab)
    S = T["num_slots"]

    model = run.config.build(cfg, run.seed, dev)
    eng = Engine(model, num_slots=S)
    harness.log(f"[setup] engine {S} slots, core {type(eng.core).__name__}, "
                f"{len(sched)} requests at {T['rate_per_s']} / s over {run.seconds} s")
    warm_up(eng, T, run.seed, length, vocab)
    if run.trace_on and cuda:
        warm_profiler()

    t0 = run.begin_window()
    out = serve(eng, sched, T, uncond, t0, run.seconds, trace=run.trace_on and cuda,
                on_close=run.read_peak_memory)
    done_t, lat, late, n = out["done_t"], out["lat"], out["late"], out["n"]
    run.attempted, run.failed = n, n - len(done_t)
    done_by_close = sum(t <= out["end"] for t in done_t.values())
    run.e2e["latency_p90_s"] = float(np.percentile(lat, 90))
    run.e2e["peak_mem_gib"] = run.memory_peak / 2 ** 30
    harness.log(f"[serve] {done_by_close} images back by the close; sent {out['sent']} of {n}, "
                f"succeeded {len(done_t)}, failed {run.failed}; latency p50 {np.percentile(lat, 50):.4f} s p90 "
                f"{np.percentile(lat, 90):.4f} s; generator late p50 "
                f"{1e3 * np.percentile(late, 50):.3f} ms max {1e3 * max(late):.3f} ms "
                f"(request {int(np.argmax(late))}, due at {sched[int(np.argmax(late))][0]:.2f} s); "
                f"{len(out['ticks'])} ticks, the longest {max(t['s'] for t in out['ticks']):.4f} s")
    run.records["ticks"] = [t for t in out["ticks"]
                            if t["t"] <= T["profile_after"] * run.seconds]
    run.records["denoise_flops"] = run.config.work(cfg, "denoise", 2)[0]
    run.records["decode_flops"] = run.config.work(cfg, "decode", 1)[0]
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
    run.compared = sample(run, sched, out)
    run.check("image_rms_levels", compare(run, run.compared))


def sample(run, sched, out):
    """[(steps, ids, uncond, request seed, image)] of a sample of the
    finished requests, drawn from the seed with one of the longest in it."""
    T = run.traffic
    rid_at, images = out["rid_at"], out["images"]
    finished = sorted(rid_at[r] for r in images)
    if not finished:
        return []
    rng = rng_for(run.seed, 3)
    longest = max(sched[k][1] for k in finished)
    pick = [int(rng.choice([k for k in finished if sched[k][1] == longest]))]
    rest = [k for k in finished if k != pick[0]]
    pick += [int(k) for k in rng.choice(rest, size=min(T["sample"] - 1, len(rest)), replace=False)]
    of_index = {k: r for r, k in rid_at.items()}
    uncond = prompt(None, 0, run.cfg["clip"]["max_length"], run.cfg["clip"]["vocab_size"])
    return [(sched[k][1], sched[k][2], uncond, sched[k][3], images[of_index[k]]) for k in pick]


def reference_images(run, compared, prec: str):
    """The reference's image (levels, float32) of each compared request,
    computed in ``prec``."""
    t0 = time.perf_counter()
    ref = run.config.reference(run.cfg, run.seed, run.device, prec)
    out = [ref.sd_image(ids, uncond, steps, run.traffic["guidance"], rseed)
           for steps, ids, uncond, rseed, _ in compared]
    harness.log(f"[reference {prec}] {len(out)} images in {time.perf_counter() - t0:.1f} s")
    return out


def compare(run, compared) -> float:
    """The widest rms difference, in levels, between a served image and the
    fp32 reference's of the same request."""
    if not compared:
        return float("inf")
    worst = 0.0
    for (steps, _, _, rseed, image), want in zip(compared, reference_images(run, compared, "fp32")):
        got = torch.as_tensor(image, device=want.device).float()
        rms = float((got - want).square().mean().sqrt())
        harness.log(f"[check] {steps} steps, seed {rseed}: image rms {rms:.4f} levels")
        worst = max(worst, rms)
    return worst


def control(run, compared, prec: str):
    """``compared`` with each served image replaced by the reference's
    computed in ``prec``, as the engine hands images out (uint8): the
    control put in the program's place."""
    return [c[:-1] + (want.to(torch.uint8).cpu().numpy(),)
            for c, want in zip(compared, reference_images(run, compared, prec))]
