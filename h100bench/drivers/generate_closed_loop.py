"""A closed loop of one caller through the port's SD3 ``generate``
(``tinyfusers_tpu_torch.pipeline.sd3.generate``): each call starts when
the previous image is on the host.

Traffic (traffic/<name>.json): ``batch``, ``steps``, ``guidance``,
``sampler`` (``euler`` or ``heun``), ``prompt_tokens`` [lo, hi], ``sample`` (images compared with
the reference). Every request's inputs come from the seed: the same
random ids for both CLIP towers (start token, ids, end-of-text padding),
the negative prompt of start token and padding, and the initial noise,
drawn by a Generator on the device from the request's own seed.

``images_per_s`` is the images finished in the window plus the share of
the call running at its close that lay inside it, over the window: with
some twenty images a window, counting whole images would move the rate
by 5% as the last one lands on either side of the close.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from h100bench.lib import harness, roofline
from h100bench.lib.inputs import prompt, rng_for
from h100bench.lib.trace import Slice, warm_profiler
from h100bench.reference.pipelines import DTYPES, initial_noise


def requests(traffic, cfg, latent_hw, seed: int, device, stream: int = 1):
    """Endless (ids (B, T), uncond (B, T), latent (B, h, w, C), request
    seed), on the device, the k-th the same for a seed however many are
    drawn (stream 1: the window's, 2: the warm-up's)."""
    c = cfg["clip_l"]
    length, vocab = c["max_length"], c["vocab_size"]
    rng = rng_for(seed, stream)
    b = traffic["batch"]
    shape = (b, *latent_hw, cfg["vae"]["latent_channels"])
    lo, hi = traffic["prompt_tokens"]
    dev, dtype = torch.device(device), DTYPES[cfg["dtype"]]
    uncond = torch.as_tensor(prompt(None, 0, length, vocab), device=dev)[None].expand(b, -1)
    while True:
        ids = torch.as_tensor(prompt(rng, int(rng.integers(lo, hi + 1)), length, vocab), device=dev)
        rseed = int(rng.integers(0, 2 ** 62))
        lat = initial_noise(rseed, shape, dtype, dev).to(dtype)
        yield ids[None].expand(b, -1), uncond, lat, rseed


def run(run) -> None:
    from tinyfusers_tpu_torch.pipeline import sd3

    T, cfg, dev = run.traffic, run.cfg, run.device
    cuda = torch.device(dev).type == "cuda"
    model = run.config.build(cfg, run.seed, dev)
    hw = run.config.latent_hw(cfg)
    draw = requests(T, cfg, hw, run.seed, dev)

    def call(r):
        ids, uids, lat, _ = r
        return sd3.generate(model, ids, ids, uids, uids, lat, T["guidance"],
                            num_steps=T["steps"], method=T["sampler"]).cpu()

    call(next(requests(T, cfg, hw, run.seed, dev, stream=2)))
    if run.trace_on and cuda:
        warm_profiler()
    harness.log(f"[setup] {T['steps']}-step {T['sampler']} at batch {T['batch']}, "
                f"{cfg['height']}x{cfg['width']}")

    t0 = run.begin_window()
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
                f"(call {slowest}, from {calls[slowest][1] - t0:.2f} s)")
    image_flops = (run.config.work(cfg, "encode", 2 * T["batch"])[0]
                   + T["steps"] * run.config.work(cfg, "denoise", 2 * T["batch"])[0]
                   + run.config.work(cfg, "decode", T["batch"])[0])
    run.records["calls"] = [{"s": b - a, "images": T["batch"], "flops": image_flops}
                            for _, a, b, p in done if not p]
    if sl is not None:
        run.trace = sl.summary()
        run.trace["images"] = T["batch"]
        run.trace_calls = (run.config.work(cfg, "denoise", 2 * T["batch"])[1] * T["steps"]
                           + run.config.work(cfg, "decode", T["batch"])[1])
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


def sample(run, reqs, finished, images):
    """[(ids, uncond, latent, image)] of each image of a sample of the
    finished calls, drawn from the seed."""
    if not finished:
        return []
    rng = rng_for(run.seed, 3)
    pick = rng.choice(finished, size=min(run.traffic["sample"], len(finished)), replace=False)
    return [(reqs[k][0][b].cpu().numpy(), reqs[k][1][b].cpu().numpy(), reqs[k][2][b:b + 1],
             images[k][b]) for k in pick for b in range(run.traffic["batch"])]


def reference_images(run, compared, prec: str):
    """The reference's image (levels, float32) from each compared image's
    inputs, computed in ``prec``."""
    T = run.traffic
    t0 = time.perf_counter()
    ref = run.config.reference(run.cfg, run.seed, run.device, prec)
    out = [ref.sd3_image(ids, ids, uids, uids, lat, T["steps"], T["guidance"])
           for ids, uids, lat, _ in compared]
    harness.log(f"[reference {prec}] {len(out)} images in {time.perf_counter() - t0:.1f} s")
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
