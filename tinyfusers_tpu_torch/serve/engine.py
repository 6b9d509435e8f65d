"""Continuous-batching generation engine (port of
tinyfusers_tpu/serve/engine.py).

- The device holds S fixed slots: latents (S, h, w, c) and contexts
  (2S, T, D) = [uncond(S) ‖ cond(S)], in the UNet's dtype. One denoise
  step runs the UNet on all 2S rows with per-slot timesteps, guidance and
  DDIM alphas, so requests at different progress points batch together,
  a finished request vacates its slot at a step boundary and a queued one
  joins mid-flight. Shapes never change, so every tick launches the same
  kernels at the same shapes. The step runs under an
  ``ops.conv.RowInvariance``, probed once at construction, so that a
  request's image does not depend on its slot: cuDNN rounds some
  convolutions' rows by their position in the batch, and those run one
  row at a time.
- Slot and queue bookkeeping runs in the C++ core (native/scheduler.cpp
  through ctypes), with a pure-Python core of the same semantics.
- Nothing in a tick reads the device back. The CLIP encode ([uncond ‖
  cond] in one call) and the seeded initial latent are issued at
  submit(), for at most ``stage_window`` queued requests, and admission
  copies them into the slot buffers on the device. The per-slot control
  vectors are built on the host in numpy and copied from pinned memory,
  without blocking, into a control block that stays on the device. Each
  completion's VAE decode is issued at once and copied to pinned host
  memory without blocking, behind a CUDA event; a later tick hands it out
  once the event has passed (flush() waits).
- On a card outside a mesh the slot step over the static buffers (the
  latents, contexts and control block), the copy back into the latents
  included, is captured once at construction as a CUDA graph and
  replayed every tick: the same kernels in the same order, without the
  host's cost of issuing them. A replay first waits for the step before
  it to finish, so the host runs at most one step ahead of the device
  and a request admitted now joins the next step the device runs. The
  graph holds the UNet's weights at their addresses: a model whose
  weights are replaced after that, not written in place, needs a new
  Engine. CPU engines and mesh engines (whose step runs collectives)
  step eagerly. ``stats["graph_steps"]`` counts the replays,
  ``stats["eager_steps"]`` the eager steps, construction's probe
  included. The kernel wrappers' counters (kernels/counters.py) grow at
  each replay by what the capture counted, as eager calls would.
- On a (data, model) mesh (``mesh=``) the slots split over the data axis:
  a rank holds the latents and contexts of its num_slots / n slots, its
  model (``parallel.shard_params``) split over the model axis. Every rank
  runs the same scheduler core on the same submissions (mirrored: the
  same submit() calls in the same order everywhere) and takes each tick's
  control vectors from the mesh's first rank
  (``parallel.distributed.sync_decision``), so that every rank feeds the
  step the same numbers. A rank steps its own slots. A finished slot is
  decoded by the ranks that hold it and broadcast over the data axis. On
  a mesh, and in an engine that a Router runs beside a sharded one
  (``lockstep``), a decode is handed out on the tick after the one that
  issued it, not when its event has passed, so that every rank returns
  the same Results, with the same images, in the same order, and takes
  the same number of ticks.
- Spans (utils/profiling.py; recorded only under ``profiling.tracing()``):
  ``engine.submit`` (child ``engine.stage``), ``engine.tick`` with the
  children ``engine.admit`` (any late ``engine.stage`` in it),
  ``engine.control``, ``engine.slot_step``, one ``engine.decode`` per
  completion and ``engine.harvest``; and each request's
  ``request.queued`` (submit to admission), ``request.denoise`` (to the
  tick that finished it) and ``request.decode`` (to the hand-out).
- The engine refuses what it would get wrong: a v-prediction model (the
  JAX engine feeds v to the DDIM update as if it were epsilon).
"""
from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import counters
from ..models import unet as unet_model
from ..models import vae as vae_model
from ..ops.conv import RowInvariance
from ..pipeline import ddim, sd
from ..utils import profiling


@dataclass
class Request:
    request_id: int
    prompt_ids: np.ndarray       # (T,) int token ids
    uncond_ids: np.ndarray       # (T,)
    num_steps: int = 20
    guidance: float = 7.5
    seed: int = 0


@dataclass
class Result:
    request_id: int
    image: np.ndarray            # (H, W, 3) uint8


class _PySchedulerCore:
    """Pure-Python core with native/scheduler.cpp's semantics."""

    def __init__(self, num_slots: int):
        self.queue: List = []
        self.slots = [None] * num_slots  # None | [request_id, remaining]

    def submit(self, rid: int, steps: int):
        self.queue.append((rid, steps))
        return len(self.queue)

    def assign(self):
        out = []
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                rid, steps = self.queue.pop(0)
                self.slots[i] = [rid, steps]
                out.append((rid, i, steps))
        return out

    def tick(self):
        done = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            s[1] -= 1
            if s[1] <= 0:
                done.append((s[0], i))
                self.slots[i] = None
        return done

    def active(self):
        return sum(1 for s in self.slots if s is not None)

    def pending(self):
        return len(self.queue)

    def remaining(self, slot: int) -> int:
        s = self.slots[slot]
        return s[1] if s else 0


class _NativeSchedulerCore:
    def __init__(self, lib, num_slots: int):
        self._lib = lib
        self._h = lib.tf_sched_create(num_slots)
        self._cap = num_slots

    def submit(self, rid, steps):
        return self._lib.tf_sched_submit(self._h, rid, steps)

    def assign(self):
        req = (ctypes.c_long * self._cap)()
        slot = (ctypes.c_int * self._cap)()
        steps = (ctypes.c_int * self._cap)()
        n = self._lib.tf_sched_assign(self._h, req, slot, steps, self._cap)
        return [(req[i], slot[i], steps[i]) for i in range(n)]

    def tick(self):
        req = (ctypes.c_long * self._cap)()
        slot = (ctypes.c_int * self._cap)()
        n = self._lib.tf_sched_tick(self._h, req, slot, self._cap)
        return [(req[i], slot[i]) for i in range(n)]

    def active(self):
        return self._lib.tf_sched_active(self._h)

    def pending(self):
        return self._lib.tf_sched_pending(self._h)

    def remaining(self, slot):
        return self._lib.tf_sched_slot_steps_remaining(self._h, slot)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tf_sched_destroy(self._h)


def make_scheduler_core(num_slots: int, prefer_native: bool = True):
    if prefer_native:
        from ..native import get_lib

        lib = get_lib()
        if lib is not None:
            return _NativeSchedulerCore(lib, num_slots)
    return _PySchedulerCore(num_slots)


# rows of the per-tick control block uploaded to the device
_T, _A_T, _A_PREV, _ACTIVE, _GUIDANCE = range(5)


class Engine:
    def __init__(
        self,
        model: sd.StableDiffusion,
        cfg: Optional[sd.SDConfig] = None,
        *,
        num_slots: int = 4,
        prefer_native: bool = True,
        mesh=None,
        stage_window: Optional[int] = None,
    ):
        """model: a pipeline.sd.StableDiffusion; the engine runs on its
        device in its UNet's dtype. cfg, if given, must be model.cfg.

        mesh: a (data, model) mesh (parallel.make_mesh); num_slots must
        divide over its data axis, and model should be split over its model
        axis already (parallel.shard_params).

        stage_window: how many queued requests may hold issued device
        state (CLIP context + initial latent) ahead of admission; default
        2 x num_slots, so a deep queue holds O(slots) device memory, not
        O(queue), and the window is topped up as slots are assigned."""
        cfg = model.cfg if cfg is None else cfg
        if cfg != model.cfg:
            raise ValueError("Engine: cfg is not the model's config")
        if cfg.prediction_type != "epsilon":
            raise ValueError(
                f"Engine: prediction_type {cfg.prediction_type!r} is not served: the "
                "slot step's DDIM update takes epsilon predictions (the JAX engine "
                "would treat v as epsilon and return a wrong image)")
        n, r, group = 1, 0, None
        if mesh is not None:
            from ..parallel.mesh import DATA_AXIS, axis

            n, r, group = axis(mesh, DATA_AXIS)
            if num_slots % n:
                raise ValueError(f"Engine: num_slots {num_slots} does not divide over the "
                                 f"{n} ranks of the mesh's data axis")
        param = next(model.unet.parameters())
        self.model = model
        self.cfg = cfg
        self.S = num_slots
        self.mesh = mesh
        # this rank's slots: [first, first + local_slots) of the S
        self._data_n, self._data_group = n, group
        self.local_slots = num_slots // n
        self._first = r * self.local_slots
        self.device = param.device
        self.dtype = param.dtype
        self.core = make_scheduler_core(num_slots, prefer_native)
        h, w, c = cfg.latent_shape
        s_l = self.local_slots
        self.latents = torch.zeros((s_l, h, w, c), dtype=self.dtype, device=self.device)
        self.contexts = torch.zeros((2 * s_l, cfg.clip.max_length, cfg.clip.dim),
                                    dtype=self.dtype, device=self.device)
        self._tick = 0
        # hand decodes out by tick, not by event, so that the ranks keep step
        # (a Router sets it on the engines beside a sharded one)
        self.lockstep = mesh is not None
        self.guidance = np.zeros((num_slots,), np.float32)
        self._steps_total: Dict[int, int] = {}     # slot -> total steps
        self._ladders: Dict[int, np.ndarray] = {}  # per distinct num_steps
        self._acp = ddim.alphas_cumprod().numpy()  # host copy, read once
        self._next_rid = 0
        self._requests: Dict[int, Request] = {}    # in flight and queued only
        # (rid, host uint8 image, CUDA event of its copy or None on the CPU,
        # the tick that issued it)
        self._pending_decodes: List = []
        # rid -> (ctx2 (2, T, D) [uncond ‖ cond], lat0 (1, h, w, c)) on the
        # device, for at most stage_window queued requests; the overflow
        # stages in FIFO order (the scheduler core's) as the window drains.
        self._staged: Dict[int, tuple] = {}
        self._unstaged: List[int] = []
        self.stage_window = 2 * num_slots if stage_window is None else stage_window
        # time-to-first-image observability (serving cold-start metric), and
        # how the slot steps ran
        self.stats = {"submitted": 0, "completed": 0,
                      "first_submit_t": None, "first_result_s": None,
                      "graph_steps": 0, "eager_steps": 0}
        # the control block on the device; all slots inactive (the identity)
        idle = np.zeros((5, s_l), np.float32)
        idle[_A_T] = idle[_A_PREV] = 1.0
        self._ctl = torch.from_numpy(idle).to(self.device)
        # one step on the empty slots probes every convolution of the step
        # now, so that no tick reads back; on a card outside a mesh it runs on
        # the capture stream, as the warm-up of the graph captured next
        self._rows = RowInvariance()
        self._graph = self._graph_counts = self._step_done = None
        capture = self.device.type == "cuda" and mesh is None
        stream = torch.cuda.Stream(self.device) if capture else None
        with torch.inference_mode(), self._rows:
            if capture:
                stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):  # None: the current stream
                self._step_in_place()
            self.stats["eager_steps"] += 1
            if capture:
                self._capture(stream)

    # -- the per-tick step over all slots ---------------------------------

    @staticmethod
    def _slot_step(unet, latents, contexts, guidance, t, a_t, a_prev, active):
        """Denoise every slot by one step: latents (S, h, w, c), contexts
        (2S, T, D), the rest (S,); inactive slots keep their latents."""
        s = latents.shape[0]
        eps = unet_model.apply(unet, torch.cat([latents, latents], dim=0),
                               torch.cat([t, t], dim=0), contexts)
        e_t = ddim.cfg_combine(eps[:s], eps[s:], guidance[:, None, None, None])
        new = ddim.ddim_step(latents, e_t, a_t[:, None, None, None],
                             a_prev[:, None, None, None])
        return torch.where(active[:, None, None, None], new, latents)

    def _step_in_place(self) -> None:
        """The slot step over the static buffers: the latents, the contexts
        and the control block; the new latents are written back."""
        v = self._ctl
        self.latents.copy_(self._slot_step(self.model.unet, self.latents, self.contexts,
                                           v[_GUIDANCE], v[_T], v[_A_T], v[_A_PREV],
                                           v[_ACTIVE] > 0.5))

    def _capture(self, stream: torch.cuda.Stream) -> None:
        """Capture ``_step_in_place`` as one CUDA graph on ``stream``, warm
        from the probe step. The capture launches nothing, so the kernel
        wrappers' counters are set back to what they read before it, and
        each replay adds what it counted. Raises with the cause if the step
        cannot be captured."""
        before = counters.snapshot()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=stream):
                self._step_in_place()
        except RuntimeError as e:
            raise RuntimeError(f"Engine: the slot step could not be captured as a CUDA "
                               f"graph: {e}") from e
        finally:
            counts = counters.take(before)
        self._graph, self._graph_counts = graph, counts
        self._step_done = torch.cuda.Event()

    def _run_step(self) -> None:
        """One slot step over every slot, from the control block on the
        device: the graph's replay where there is one, else eagerly."""
        if self._graph is None:
            with self._rows:
                self._step_in_place()
            self.stats["eager_steps"] += 1
            return
        self._step_done.synchronize()  # the step before: at most one queued
        self._graph.replay()  # on the capture device's current stream
        self._step_done.record(torch.cuda.current_stream(self.device))
        counters.add(self._graph_counts)
        self.stats["graph_steps"] += 1

    def _pinned(self, host: np.ndarray) -> torch.Tensor:
        """A host array in a pinned buffer of its own on a card, to copy from
        without waiting (the caching host allocator hands the buffer out
        again only after the copy's event has passed); as it is on the
        CPU."""
        x = torch.from_numpy(host)
        return x.pin_memory() if self.device.type == "cuda" else x

    # -- public API ---------------------------------------------------------

    @torch.inference_mode()
    def submit(self, req: Request) -> int:
        with profiling.span("engine.submit"):
            profiling.begin("request.queued", req.request_id, self)
            self.core.submit(req.request_id, req.num_steps)
            self._requests[req.request_id] = req
            if self.stats["first_submit_t"] is None:
                self.stats["first_submit_t"] = time.perf_counter()
            self.stats["submitted"] += 1
            # Issue the encode and the initial latent now, so that admission
            # finds them on the device; only the first stage_window queued
            # requests hold device state.
            if len(self._staged) < self.stage_window:
                self._stage(req)
            else:
                self._unstaged.append(req.request_id)
        return req.request_id

    def _stage(self, req: Request) -> None:
        with profiling.span("engine.stage"):
            ids2 = np.stack([np.asarray(req.uncond_ids),
                             np.asarray(req.prompt_ids)]).astype(np.int64)
            ids2 = self._pinned(ids2).to(self.device, non_blocking=True)
            ctx2 = sd.encode_text(self.model, ids2)
            lat0 = sd.initial_latent(req.seed, 1, self.cfg, device=self.device, dtype=self.dtype)
            self._staged[req.request_id] = (ctx2, lat0)

    def _inject(self, slot: int, lat0: torch.Tensor, ctx2: torch.Tensor) -> None:
        """One admitted request's state into its slot, on the device, by the
        ranks that hold the slot."""
        i = slot - self._first
        if 0 <= i < self.local_slots:
            self.latents[i] = lat0[0]
            self.contexts[i] = ctx2[0]
            self.contexts[i + self.local_slots] = ctx2[1]

    def _decode(self, slot: int) -> torch.Tensor:
        """The uint8 image (H, W, 3) of a finished slot, on every rank: the
        ranks of its data index decode it, then broadcast it over the data
        axis."""
        i = slot - self._first
        if 0 <= i < self.local_slots:
            img = vae_model.to_image(vae_model.decode(self.model.vae,
                                                      self.latents[i:i + 1]))[0]
        else:
            img = torch.empty((self.cfg.height, self.cfg.width, 3), dtype=torch.uint8,
                              device=self.device)
        if self._data_n > 1:
            owner = dist.get_global_rank(self._data_group, slot // self.local_slots)
            img = img.contiguous()
            dist.broadcast(img, src=owner, group=self._data_group)
        return img

    def reset(self) -> None:
        """Drop all queued and in-flight state; keep the model and the
        device buffers (failure recovery reuses them)."""
        self.core = make_scheduler_core(self.S, isinstance(self.core, _NativeSchedulerCore))
        self._steps_total.clear()
        self._requests.clear()
        self._pending_decodes.clear()
        self._staged.clear()
        self._unstaged.clear()
        self.guidance[:] = 0.0
        profiling.forget(self)

    def make_request(self, prompt_ids, uncond_ids, *, num_steps=20,
                     guidance=7.5, seed=0) -> Request:
        rid = self._next_rid
        self._next_rid += 1
        return Request(rid, np.asarray(prompt_ids), np.asarray(uncond_ids),
                       num_steps, guidance, seed)

    def _ladder(self, num_steps: int) -> np.ndarray:
        if num_steps not in self._ladders:
            self._ladders[num_steps] = ddim.ddim_timesteps_np(num_steps)
        return self._ladders[num_steps]

    @torch.inference_mode()
    def step(self) -> List[Result]:
        """One scheduler tick: admit, denoise every active slot by one
        step, issue the decodes of completions, hand out the decoded
        results that are ready. Nothing here waits for the device, but a
        replay for the step before it, a lockstep engine's collectives and
        its handing out of a decode whose copy is still in flight."""
        with profiling.span("engine.tick"):
            self._tick += 1
            with profiling.span("engine.admit"):
                self._admit()
            with profiling.span("engine.control"):
                ctl = self._control()
                active = bool(ctl[_ACTIVE].any())
                if active:
                    self._ctl.copy_(self._pinned(ctl), non_blocking=True)
            if active:
                with profiling.span("engine.slot_step"):
                    self._run_step()
            for rid, slot in self.core.tick():
                with profiling.span("engine.decode"):
                    profiling.end("request.denoise", rid, self)
                    profiling.begin("request.decode", rid, self)
                    self._issue_decode(rid, slot)
            with profiling.span("engine.harvest"):
                return self._harvest(block=False)

    def _admit(self) -> None:
        """Assign queued requests to free slots and copy their staged state
        in; top the staging window back up."""
        for rid, slot, steps in self.core.assign():
            profiling.end("request.queued", rid, self)
            profiling.begin("request.denoise", rid, self)
            req = self._requests[rid]
            self._steps_total[slot] = steps
            self.guidance[slot] = req.guidance
            if rid not in self._staged:  # beyond the window: stage now
                self._unstaged.remove(rid)
                self._stage(req)
            ctx2, lat0 = self._staged.pop(rid)
            self._inject(slot, lat0, ctx2)
        # top the window back up (FIFO), so the next admissions find their
        # encodes already issued
        while self._unstaged and len(self._staged) < self.stage_window:
            nxt = self._unstaged.pop(0)
            if nxt in self._requests:
                self._stage(self._requests[nxt])

    def _control(self) -> np.ndarray:
        """The tick's control block (rows _T, _A_T, _A_PREV, _ACTIVE,
        _GUIDANCE) over this rank's slots: per-slot (t, a_t, a_prev) from
        the remaining counts; inactive slots get the identity (a_t = a_prev
        = 1)."""
        ctl = np.zeros((5, self.S), np.float32)
        ctl[_A_T] = ctl[_A_PREV] = 1.0
        ctl[_GUIDANCE] = self.guidance
        for slot in range(self.S):
            rem = self.core.remaining(slot)
            if rem <= 0:
                continue
            ladder = self._ladder(self._steps_total[slot])
            idx = rem - 1  # remaining steps -> position in the ascending ladder
            ts = ladder[idx]
            ctl[_T, slot] = ts
            ctl[_A_T, slot] = self._acp[ts]
            ctl[_A_PREV, slot] = self._acp[ladder[idx - 1]] if idx > 0 else 1.0
            ctl[_ACTIVE, slot] = 1.0

        if self.mesh is not None:  # rows (t, a_t, a_prev, active, guidance): rank 0's
            from ..parallel.distributed import sync_decision

            ctl = sync_decision(ctl, self.mesh)
            ctl = np.ascontiguousarray(ctl[:, self._first:self._first + self.local_slots])
        return ctl

    def _issue_decode(self, rid: int, slot: int) -> None:
        """Issue a finished slot's decode and its copy to pinned host memory
        behind an event; a later harvest hands it out."""
        img = self._decode(slot)
        event = None
        if img.is_cuda:  # copy out behind an event, harvested when it passed
            host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
            host.copy_(img, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            img = host
        self._pending_decodes.append((rid, img, event, self._tick))
        self._steps_total.pop(slot, None)
        self._requests.pop(rid, None)

    def _harvest(self, block: bool) -> List[Result]:
        done, still = [], []
        for rid, img, event, tick in self._pending_decodes:
            if self.lockstep:  # out on the tick after its own, on every rank
                ready = block or tick < self._tick
            else:
                ready = block or event is None or event.query()
            if ready:
                if event is not None:
                    event.synchronize()
                profiling.end("request.decode", rid, self)
                done.append(Result(rid, img.numpy()))
                if self.stats["first_result_s"] is None:
                    self.stats["first_result_s"] = (
                        time.perf_counter() - self.stats["first_submit_t"])
                self.stats["completed"] += 1
            else:
                still.append((rid, img, event, tick))
        self._pending_decodes = still
        return done

    def flush(self) -> List[Result]:
        """Wait for and return every outstanding decoded result."""
        return self._harvest(block=True)

    def run_until_idle(self, max_ticks: int = 10000) -> List[Result]:
        out = []
        for _ in range(max_ticks):
            if not (self.core.active() or self.core.pending()):
                break
            out.extend(self.step())
        out.extend(self.flush())
        return out
