"""A closed loop of one caller through the port's FLUX ``generate``
(``tinyfusers_tpu_torch.pipeline.flux.generate``): each call starts when
the previous image is on the host.

Traffic (traffic/<name>.json): ``batch``, ``steps``, ``guidance`` (the
distilled guidance embedded at every step; no CFG batch),
``prompt_tokens`` [lo, hi], ``sample`` (images compared with the
reference). Every request's inputs come from the seed: n random CLIP ids
(start token, ids, end-of-text padding to the CLIP length) and n random
T5 ids (ids in [2, 32100), the tokenizer's, EOS 1, pad 0 to
``max_sequence_length``), n drawn from ``prompt_tokens``, and the initial
noise, drawn by a Generator on the device from the request's own seed.

The rules are those of generate_closed_loop.py: ``images_per_s`` is the
images finished in the window plus the share of the call running at its
close that lay inside it, over the window; the peak memory is read at
the close; the profiled call is the second; the sample is drawn as
there. In a traced run the port's
span recording (``profiling.tracing()``) is on from ``run.begin_window()``
to the close, and the drained spans, their clock and the profiled Slice
are left in ``run.records`` for lib/spans.py.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from h100bench.drivers.generate_closed_loop import sample
from h100bench.lib import harness, roofline
from h100bench.lib.inputs import prompt, rng_for
from h100bench.lib.trace import Slice, warm_profiler
from h100bench.reference.pipelines import DTYPES, initial_noise

T5_IDS = 32100   # the T5 tokenizer's ids; 0 pad, 1 end of sequence


def t5_prompt(rng, n_tokens: int, length: int, vocab: int) -> np.ndarray:
    """n_tokens random ids, then end of sequence (1), then padding (0)."""
    ids = np.zeros((length,), np.int64)
    ids[:n_tokens] = rng.integers(2, min(T5_IDS, vocab), size=n_tokens)
    ids[n_tokens] = 1
    return ids


def requests(traffic, cfg, latent_hw, seed: int, device, stream: int = 1):
    """Endless (CLIP ids (B, 77), T5 ids (B, T), latent (B, h, w, C),
    request seed) on the device, the k-th the same for a seed however many
    are drawn (stream 1: the window's, 2: the warm-up's)."""
    c = cfg["clip"]
    rng = rng_for(seed, stream)
    b = traffic["batch"]
    shape = (b, *latent_hw, cfg["vae"]["latent_channels"])
    lo, hi = traffic["prompt_tokens"]
    dev, dtype = torch.device(device), DTYPES[cfg["dtype"]]
    while True:
        n = int(rng.integers(lo, hi + 1))
        ids = torch.as_tensor(prompt(rng, n, c["max_length"], c["vocab_size"]), device=dev)
        t5 = t5_prompt(rng, n, cfg["max_sequence_length"], cfg["t5"]["vocab_size"])
        t5 = torch.as_tensor(t5, device=dev)
        rseed = int(rng.integers(0, 2 ** 62))
        lat = initial_noise(rseed, shape, dtype, dev).to(dtype)
        yield ids[None].expand(b, -1), t5[None].expand(b, -1), lat, rseed


def run(run) -> None:
    from tinyfusers_tpu_torch.pipeline import flux
    from tinyfusers_tpu_torch.utils import profiling

    T, cfg, dev = run.traffic, run.cfg, run.device
    cuda = torch.device(dev).type == "cuda"
    model = run.config.build(cfg, run.seed, dev)
    hw = run.config.latent_hw(cfg)
    draw = requests(T, cfg, hw, run.seed, dev)

    def call(r, steps=T["steps"]):
        ids, t5, lat, _ = r
        return flux.generate(model, ids, t5, lat, T["guidance"], num_steps=steps).cpu()

    # every step has the same shapes: two build and warm what the window runs
    call(next(requests(T, cfg, hw, run.seed, dev, stream=2)), steps=2)
    if run.trace_on and cuda:
        warm_profiler()
    harness.log(f"[setup] FLUX {T['steps']} Euler flow steps at batch {T['batch']}, "
                f"{cfg['height']}x{cfg['width']}, guidance {T['guidance']}")

    spans = contextlib.ExitStack()
    t0 = run.begin_window()
    if run.trace_on:
        profiling.drain()
        spans.enter_context(profiling.tracing())
    end = t0 + run.seconds
    calls, images, reqs, sl = [], {}, [], None
    k = 0
    while True:
        t_a = time.perf_counter()
        if t_a >= end:
            break
        reqs.append(next(draw))
        profiled = run.trace_on and cuda and k == 1
        if profiled:
            sl = Slice(counters=roofline.counter_launches)
            sl.start()
            t_a = time.perf_counter()
        with torch.profiler.record_function("bench:generate"):
            images[k] = call(reqs[k])
        if profiled:
            sl.stop()
        t_b = time.perf_counter()
        calls.append((k, t_a, t_b, profiled))
        k += 1
    run.read_peak_memory()
    spans.close()
    if run.trace_on:
        run.records["spans"], run.records["clock"] = profiling.drain()
        run.records["slice"] = sl

    done = [c for c in calls if c[2] <= end]
    last = calls[-1]
    part = 0.0 if last[2] <= end else (end - last[1]) / (last[2] - last[1])
    run.attempted, run.failed = len(calls), 0
    run.e2e["images_per_s"] = T["batch"] * (len(done) + part) / run.seconds
    run.e2e["peak_mem_gib"] = run.memory_peak / 2 ** 30
    secs = {k: b - a for k, a, b, p in calls if not p}
    slowest = max(secs, key=secs.get)
    harness.log(f"[gen] {len(calls)} calls, {len(done)} inside the window (+{part:.4f}); "
                f"s a call min {min(secs.values()):.4f} median "
                f"{float(np.median(list(secs.values()))):.4f} max {secs[slowest]:.4f} "
                f"(call {slowest}, from {calls[slowest][1] - t0:.2f} s); peak "
                f"{run.memory_peak} B")
    b = T["batch"]
    image_flops = (run.config.work(cfg, "encode", b)[0]
                   + T["steps"] * run.config.work(cfg, "denoise", b)[0]
                   + run.config.work(cfg, "decode", b)[0])
    run.records["calls"] = [{"s": t1 - t0_, "images": b, "flops": image_flops}
                            for _, t0_, t1, p in done if not p]
    if sl is not None:
        run.trace = sl.summary()
        run.trace["images"] = b
        run.trace_calls = (run.config.work(cfg, "denoise", b)[1] * T["steps"]
                           + run.config.work(cfg, "decode", b)[1])
        run.trace["counter_launches"] = sl.counts
        harness.log(f"[trace] one call, {run.trace['launches']} kernels, busy "
                    f"{run.trace['busy_s']:.4f} of {run.trace['window_s']:.4f} s; "
                    f"{roofline.cross_check(run)}")

    del model
    if cuda:
        torch.cuda.empty_cache()
    run.check("unanswered", run.failed, 0)
    run.compared = sample(run, reqs, [c[0] for c in done], images)
    run.check("image_rms_levels", compare(run, run.compared))


def reference_images(run, compared, prec: str):
    """The reference's image (levels, float32) from each compared image's
    inputs, computed in ``prec``."""
    T = run.traffic
    t0 = time.perf_counter()
    ref = run.config.reference(run.cfg, run.seed, run.device, prec)
    out = [ref.flux_image(ids, t5, lat, T["steps"], T["guidance"]) for ids, t5, lat, _ in compared]
    harness.log(f"[reference {prec}] {len(out)} images in {time.perf_counter() - t0:.1f} s")
    del ref
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def compare(run, compared) -> float:
    """The widest rms difference, in levels, between a generated image and
    the fp32 reference's from the same inputs."""
    if not compared:
        return float("inf")
    worst = 0.0
    for (_, _, _, image), want in zip(compared, reference_images(run, compared, "fp32")):
        rms = float((image.to(want.device).float() - want).square().mean().sqrt())
        harness.log(f"[check] image rms {rms:.4f} levels")
        worst = max(worst, rms)
    return worst


def control(run, compared, prec: str):
    """``compared`` with each generated image replaced by the reference's
    computed in ``prec``, as generate returns images (uint8): the control
    put in the program's place."""
    return [c[:-1] + (want.to(torch.uint8).cpu(),)
            for c, want in zip(compared, reference_images(run, compared, prec))]
