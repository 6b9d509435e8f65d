"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Drives tinyfusers_tpu_torch's SD1.5 text-to-image path on the card, with
seeded random weights made on the card, and holds every hand-written
CUDA kernel of that path against its plain PyTorch version. Imports
neither jax nor tinyfusers_tpu. Phases, one or more lines each:

1. device: name, count, and nvidia-smi's name and power limit;
2. build: the kernels compiled from tinyfusers_tpu_torch/csrc (seconds,
   and ptxas's register / shared-memory report);
3. kernels: each kernel against its plain version at every main-path
   shape, bf16 and fp32, with its error and tolerance, its time, the plain
   version's time, the library call's time where one computes the same
   function (all device times, from CUDA-graph replays), and the bound from the shapes and the card's published peaks;
4. unet: one full-width SD1.5 UNet forward at 256x256 (32x32 latents, so
   the 1024-token level takes the packed kernel and every FF the GEGLU
   kernel) in fp32 on the card, against the same weights on the CPU;
5. main path: ``generate`` at SD1.5 512x512, 20-step DDIM, CFG 7.5, bf16,
   batch 1: one warm-up through the pipeline's stages (finite latents),
   then one image with the launch counts set to 0 just before it and read
   just after (exactly 400 flash_packed, 1 flash_bhsd, 320 geglu, each at
   a shape that phase 3 measured), then two more images; seconds per
   image by the host clock after synchronize, and peak device memory;
6. profile: one more image of the same model and inputs under
   ``torch.profiler``: its host seconds, the summed device time, the
   device's busy share, the number of device kernels, and the device time
   by kernel group (the port's kernels, cuDNN convolution, cuBLAS,
   reductions, elementwise, other);
7. the ``kernels`` JSON line: per kernel the main path's launches, and per
   shape the launches counted there beside the per-call times of phase 3;
   the per-image times are those counts times those per-call times. Then
   nvidia-smi's line again, then the last line ``{"ok": true, ...}``.

Any failed phase exits non-zero before the last line. Without a CUDA
GPU, or without the repository beside it, it exits non-zero at once.

fp32 comparisons are exact fp32: TF32 is switched off for matmuls and
cuDNN convolutions (torch.backends.*.allow_tf32 = False) for the whole run.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published dense peaks (NVIDIA data sheet), for the bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

STEPS = 20
GUIDANCE = 7.5

# Device-kernel name fragments -> group, for the profile phase.
GROUPS = (
    ("flash_fwd", "port: flash attention"),
    ("geglu_ff", "port: geglu"),
    ("conv", "convolution (cuDNN)"),
    ("fprop", "convolution (cuDNN)"),  # sm90_xmma_fprop_implicit_gemm...
    ("gemm", "matrix products (cuBLAS)"),
    ("sm90_xmma", "matrix products (cuBLAS)"),
    ("cutlass", "matrix products (cuBLAS)"),
    ("reduce", "reductions (norm statistics)"),
    ("elementwise", "elementwise"),
)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def say(*a) -> None:
    print(*a, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


@functools.cache
def side_stream() -> torch.cuda.Stream:
    """The one capture stream: cuBLAS keeps a workspace per stream it has
    run on, so a new stream per timing would hold more memory each time."""
    return torch.cuda.Stream()


def cuda_ms(fn, n: int) -> float:
    """Device time of one call: n calls captured in a CUDA graph, warm,
    timed by events around a replay. Eager back-to-back calls would time
    the host's issue rate for the short calls instead (the image's host
    cost is in s/image and the profile)."""
    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm: builds the kernels and sets their attributes
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def rel_err(got: torch.Tensor, want: torch.Tensor):
    g, w = got.float(), want.float()
    d = g - w
    return d.abs().max().item(), (d.norm() / w.norm().clamp_min(1e-30)).item()


def bound(flops: float, nbytes: float, dtype) -> tuple:
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def profile(run) -> dict:
    """Host seconds of run() and its device kernels' time by group."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    groups, n_kernels = {}, 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            low = evt.name.lower()
            label = next((g for key, g in GROUPS if key in low), "other")
            groups[label] = groups.get(label, 0.0) + evt.device_time_total / 1e3
            n_kernels += 1
    device_ms = sum(groups.values())
    return {"host_s": host_s, "device_ms": device_ms, "device_kernels": n_kernels,
            "device_busy_share": device_ms / (host_s * 1e3),
            "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA GPU: this smoke run needs one")
    if not (ROOT / "tinyfusers_tpu_torch").is_dir():
        fail("tinyfusers_tpu_torch/ not found beside chip_smoke.py")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import torch.nn.functional as F

    from tinyfusers_tpu_torch.kernels import _build
    from tinyfusers_tpu_torch.kernels.flash_attention import (
        flash_bhsd, flash_bhsd_plain, flash_packed, flash_packed_plain)
    from tinyfusers_tpu_torch.kernels.geglu_ff import geglu_matmul, geglu_matmul_plain
    from tinyfusers_tpu_torch.models import unet as unet_mod
    from tinyfusers_tpu_torch.models import vae as vae_mod
    from tinyfusers_tpu_torch.models.layers import init_weights
    from tinyfusers_tpu_torch.pipeline import sd

    wrappers = {"flash_packed": flash_packed, "flash_bhsd": flash_bhsd,
                "geglu": geglu_matmul}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
            w.shapes.clear()

    # 1. device ----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = smi()
    say(f"[device] {name} count={count} torch={torch.__version__} "
        f"cuda={torch.version.cuda} nvidia-smi: {card}; TF32 off for matmul "
        f"and cuDNN, so fp32 comparisons are exact fp32")
    dev = torch.device("cuda:0")

    # 2. build -----------------------------------------------------------
    build_s = _build.build_all()
    say(f"[build] kernels from tinyfusers_tpu_torch/csrc built in {build_s:.2f} s")
    for stem, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "Used" in line or "spill" in line.lower():
                say(f"[build] {stem}: {line.strip()}")

    # 3. each kernel against its plain version ---------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # Tolerances on ||kernel - plain|| / ||plain||. fp32: both sides are
    # exact fp32 and differ only in summation order. bf16 attention: the
    # kernel rounds P to bf16 against a running (per 64-key tile) max, the
    # plain version against the row's global max, so P's roundings differ.
    # bf16 GEGLU: fp32 sums in another order, then one bf16 rounding.
    tol = {("attn", torch.bfloat16): 1e-2, ("attn", torch.float32): 1e-5,
           ("geglu", torch.bfloat16): 2e-3, ("geglu", torch.float32): 1e-5}
    # (label, call shape as the wrapper counts it): every shape the main
    # path gives each kernel; phase 5 fails if it gives one not listed.
    packed_shapes = [("64x64 self", (2, 4096, 4096, 320, 8)),
                     ("64x64 cross", (2, 4096, 77, 320, 8)),
                     ("32x32 self", (2, 1024, 1024, 640, 8)),
                     ("32x32 cross", (2, 1024, 77, 640, 8))]
    bhsd_shapes = [("VAE mid", (1, 4096, 4096, 512))]
    geglu_shapes = [("64x64", (8192, 1280, 320)),
                    ("32x32", (2048, 2560, 640)),
                    ("16x16", (512, 5120, 1280)),
                    ("8x8 mid", (128, 5120, 1280))]
    report = {kname: {} for kname in wrappers}  # kname -> shape -> bf16 row

    def record(kname, label, key, dt, err, t_k, t_p, t_lib, flops, nbytes, limit):
        b_ms, b_by = bound(flops, nbytes, dt)
        lib = "n/a" if t_lib is None else f"{t_lib:.4f}"
        say(f"[kernel] {kname} {label} {str(dt)[6:]}: max_abs={err[0]:.3e} "
            f"rel={err[1]:.3e} (tol {limit:.0e}) kernel_ms={t_k:.4f} "
            f"plain_ms={t_p:.4f} library_ms={lib} bound_ms={b_ms:.4f} ({b_by})")
        if not err[1] <= limit:
            fail(f"{kname} {label} {dt}: rel err {err[1]:.3e} > {limit:.0e}")
        if dt == torch.bfloat16:
            report[kname][key] = dict(
                shape=label, call=list(key), max_abs_err=err[0], rel_err=err[1],
                ms=t_k, plain_ms=t_p, library_ms=t_lib, bound_ms=b_ms, bound_by=b_by)

    for dt in (torch.bfloat16, torch.float32):
        isz = torch.tensor([], dtype=dt).element_size()
        for label, (b, sq, sk, c, h) in packed_shapes:
            q, k, v = randn(b, sq, c, dtype=dt), randn(b, sk, c, dtype=dt), randn(b, sk, c, dtype=dt)
            got = flash_packed(q, k, v, heads=h)
            torch.cuda.synchronize()
            err = rel_err(got, flash_packed_plain(q, k, v, heads=h))
            t_k = cuda_ms(lambda: flash_packed(q, k, v, heads=h), 10)
            t_p = cuda_ms(lambda: flash_packed_plain(q, k, v, heads=h), 3)
            split = lambda x, s: x.view(b, s, h, c // h).transpose(1, 2)  # noqa: E731
            qh, kh, vh = split(q, sq), split(k, sk), split(v, sk)
            t_l = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 10)
            flops = 4.0 * b * sq * sk * c
            nbytes = (2 * b * sq * c + 2 * b * sk * c) * isz
            record("flash_packed", label, (b, sq, sk, c, h), dt, err, t_k, t_p, t_l, flops, nbytes,
                   tol[("attn", dt)])
        for label, (n, sq, sk, d) in bhsd_shapes:
            q = randn(1, n, sq, d, dtype=dt)
            k, v = randn(1, n, sk, d, dtype=dt), randn(1, n, sk, d, dtype=dt)
            got = flash_bhsd(q, k, v)
            torch.cuda.synchronize()
            err = rel_err(got, flash_bhsd_plain(q, k, v))
            t_k = cuda_ms(lambda: flash_bhsd(q, k, v), 10)
            t_p = cuda_ms(lambda: flash_bhsd_plain(q, k, v), 3)
            t_l = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10)
            flops = 4.0 * n * sq * sk * d
            nbytes = (2 * n * sq * d + 2 * n * sk * d) * isz
            record("flash_bhsd", label, (n, sq, sk, d), dt, err, t_k, t_p, t_l, flops, nbytes,
                   tol[("attn", dt)])
        for label, (m, kd, nd) in geglu_shapes:
            proj = randn(m, 2 * kd, dtype=dt)
            gx, gate = proj.chunk(2, dim=-1)  # strided halves, as in the UNet
            w = (randn(nd, kd, dtype=torch.float32) * kd ** -0.5).to(dt).t()
            bias = randn(nd, dtype=dt)
            got = geglu_matmul(gx, gate, w, bias)
            torch.cuda.synchronize()
            err = rel_err(got, geglu_matmul_plain(gx, gate, w, bias))
            t_k = cuda_ms(lambda: geglu_matmul(gx, gate, w, bias), 20)
            t_p = cuda_ms(lambda: geglu_matmul_plain(gx, gate, w, bias), 5)
            flops = 2.0 * m * kd * nd
            nbytes = (2 * m * kd + kd * nd + m * nd + nd) * isz
            record("geglu", label, (m, kd, nd), dt, err, t_k, t_p, None, flops, nbytes,
                   tol[("geglu", dt)])
        del q, k, v, proj, gx, gate, w, got
        torch.cuda.empty_cache()

    # 4. kernels inside the model: UNet fp32, card vs CPU -----------------
    cfg = sd.SD15
    unet_gpu = unet_mod.UNet(cfg.unet, device=dev, dtype=torch.float32)
    init_weights(unet_gpu, seed=1)
    unet_cpu = unet_mod.UNet(cfg.unet, device="cpu", dtype=torch.float32)
    unet_cpu.load_state_dict(unet_gpu.state_dict())
    g_cpu = torch.Generator().manual_seed(2)
    x = torch.randn((2, 32, 32, 4), generator=g_cpu)
    ctx = torch.randn((2, 77, 768), generator=g_cpu)
    t = torch.full((2,), 981.0)
    reset_counts()
    with torch.inference_mode():
        got = unet_mod.apply(unet_gpu, x.to(dev), t.to(dev), ctx.to(dev))
        torch.cuda.synchronize()
        n_packed, n_geglu = flash_packed.launches, geglu_matmul.launches
        want = unet_mod.apply(unet_cpu, x, t, ctx)
    err = rel_err(got.cpu(), want)
    # fp32 throughout, TF32 off: only summation order differs (cuDNN and
    # the kernels against the CPU's), compounded over ~70 layers.
    unet_tol = 1e-3
    say(f"[unet] SD1.5 UNet fp32 256x256 (2,32,32,4): card vs CPU max_abs={err[0]:.3e} "
        f"rel={err[1]:.3e} (tol {unet_tol:.0e}); kernel launches on the card: "
        f"flash_packed={n_packed} geglu={n_geglu}")
    if not (err[1] <= unet_tol and n_packed == 10 and n_geglu == 16):
        fail("UNet forward on the card disagrees with the CPU or skipped a kernel")
    del unet_gpu, unet_cpu, got, want
    torch.cuda.empty_cache()

    # 5. the main path ----------------------------------------------------
    dtype = torch.bfloat16
    t0 = time.perf_counter()
    model = sd.StableDiffusion(cfg, device=dev, dtype=dtype, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    g_ids = torch.Generator().manual_seed(3)
    ids = torch.full((1, 77), 49407, dtype=torch.long)
    ids[0, 0] = 49406
    ids[0, 1:9] = torch.randint(0, 49406, (8,), generator=g_ids)
    uncond = torch.full((1, 77), 49407, dtype=torch.long)
    uncond[0, 0] = 49406
    ids, uncond = ids.to(dev), uncond.to(dev)
    latent = sd.initial_latent(4, 1, cfg, device=dev, dtype=dtype)

    with torch.inference_mode():  # warm-up through the pipeline's stages
        c, uc = sd.encode_text(model, ids), sd.encode_text(model, uncond)
        lat = sd.sample_latents(model.unet, latent, c, uc, num_steps=STEPS,
                                guidance=GUIDANCE)
        warm_img = vae_mod.to_image(vae_mod.decode(model.vae, lat))
        torch.cuda.synchronize()
    if lat.shape != (1, 64, 64, 4) or not torch.isfinite(lat.float()).all():
        fail(f"latents {tuple(lat.shape)} not finite of shape (1, 64, 64, 4)")
    say(f"[main] warm-up: weights made on the card in {init_s:.2f} s; latents "
        f"finite, |lat| max {lat.float().abs().max().item():.3f}")

    held_gb = torch.cuda.memory_allocated() / 1e9  # weights and the warm-up's outputs
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for i in range(3):
        if i == 0:
            reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = sd.generate(model, ids, uncond, latent, GUIDANCE, num_steps=STEPS)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if i == 0:
            launches = {kname: w.launches for kname, w in wrappers.items()}
            shapes = {kname: dict(w.shapes) for kname, w in wrappers.items()}
            first = img
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if img.dtype != torch.uint8 or tuple(img.shape) != (1, 512, 512, 3):
        fail(f"image {img.dtype} {tuple(img.shape)}, want uint8 (1, 512, 512, 3)")
    want = {"flash_packed": 400, "flash_bhsd": 1, "geglu": 320}
    say(f"[main] launches in one image: {launches} (want {want})")
    if launches != want:
        fail("the main path did not launch each kernel the expected number of times")
    for kname, counted in shapes.items():
        unmeasured = set(counted) - set(report[kname])
        if unmeasured or sum(counted.values()) != launches[kname]:
            fail(f"{kname}: main-path shapes {counted} against phase 3's {list(report[kname])}")
    diff = (first.int() - warm_img.int()).abs().max().item()
    say(f"[main] SD1.5 512x512 {STEPS}-step DDIM CFG {GUIDANCE} bf16 batch 1: "
        f"s/image {[round(s, 4) for s in secs]} mean {sum(secs) / 3:.4f}; peak device "
        f"memory {peak_gb:.2f} GB ({held_gb:.2f} GB held before the images); image max diff vs warm-up {diff}; card {card}")

    # 6. profile: one more image, same model and inputs -------------------
    prof = profile(lambda: sd.generate(model, ids, uncond, latent, GUIDANCE,
                                       num_steps=STEPS))
    say(f"[profile] one SD1.5 image under torch.profiler: {json.dumps(prof)}")

    # 7. the kernels line and the contract line ---------------------------
    sources = {"flash_packed": ("tinyfusers_tpu_torch/csrc/flash_attention.cu",
                                "tinyfusers_tpu/kernels/flash_attention.py:117"),
               "flash_bhsd": ("tinyfusers_tpu_torch/csrc/flash_attention.cu",
                              "tinyfusers_tpu/kernels/flash_attention.py:31"),
               "geglu": ("tinyfusers_tpu_torch/csrc/geglu_ff.cu",
                         "tinyfusers_tpu/kernels/geglu_ff.py:48")}
    kernels = []
    for kname, by_key in report.items():
        rows = [dict(r, launches=shapes[kname].get(key, 0)) for key, r in by_key.items()]
        per = lambda field: sum(r["launches"] * r[field] for r in rows)  # noqa: E731
        ops_ms = sum(r["launches"] * r["bound_ms"] for r in rows
                     if r["bound_by"] == "operations")
        lib = None if rows[0]["library_ms"] is None else per("library_ms")
        kernels.append({
            "name": kname, "route": "cuda", "source": sources[kname][0],
            "replaces": sources[kname][1], "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": per("ms"), "plain_ms": per("plain_ms"), "bound_ms": per("bound_ms"),
            "bound_by": "operations" if ops_ms >= per("bound_ms") / 2 else "bytes",
            "library_ms": lib, "per": "one image's launches at bf16",
            "tolerance": tol[("geglu" if kname == "geglu" else "attn", torch.bfloat16)],
            "shapes": rows})
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))


if __name__ == "__main__":
    main()
