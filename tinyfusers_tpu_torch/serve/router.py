"""Multi-model request router with failure handling (port of
tinyfusers_tpu/serve/router.py).

Each model family runs its own Engine (its own slots and shapes); the
router sends a request to the engine of its model key, steps every engine
in turn each tick so that no family starves, re-queues the requests of an
engine whose step raised (the engine is reset, keeping its model and
device buffers, up to ``max_retries`` times a request), and reports each
engine's active and pending depths and failure count.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

from .engine import Engine, Request, Result
from ..utils.logging import get_logger, kv

log = get_logger("serve.router")


@dataclass
class _Tracked:
    request: Request
    model: str
    retries_left: int
    submitted_at: float = field(default_factory=time.monotonic)


class Router:
    def __init__(self, engines: Dict[str, Engine], *, max_retries: int = 1):
        """engines: model key -> Engine (e.g. {"sd15": ..., "sd21": ...}).
        Beside an engine on a mesh every engine keeps step with the ranks
        (``Engine.lockstep``), so that each rank routes the same results
        on the same tick."""
        if not engines:
            raise ValueError("Router: need at least one engine")
        if any(e.mesh is not None for e in engines.values()):
            for e in engines.values():
                e.lockstep = True
        self.engines = engines
        self.max_retries = max_retries
        self._tracked: Dict[int, _Tracked] = {}
        self._next_rid = 0
        self.failures: Dict[str, int] = {k: 0 for k in engines}

    def submit(self, model: str, prompt_ids, uncond_ids, *, num_steps: int = 20,
               guidance: float = 7.5, seed: int = 0) -> int:
        eng = self.engines[model]
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt_ids, uncond_ids, num_steps, guidance, seed)
        self._tracked[rid] = _Tracked(req, model, self.max_retries)
        eng.submit(req)
        return rid

    def step(self) -> List[Result]:
        """One tick of every engine in turn; a failed engine's requests
        are re-queued."""
        out: List[Result] = []
        for model, eng in self.engines.items():
            try:
                results = eng.step()
            except Exception as e:  # a device or launch failure in this family
                self.failures[model] += 1
                log.warning(kv(event="engine_error", model=model, error=type(e).__name__))
                results = []
                self._requeue_engine(model, eng)
            for r in results:
                self._tracked.pop(r.request_id, None)
                out.append(r)
        return out

    def _requeue_engine(self, model: str, eng: Engine) -> None:
        # reclaim every slot and resubmit the surviving requests; reset()
        # keeps the model and the device buffers
        inflight = [t for t in self._tracked.values() if t.model == model]
        eng.reset()
        for t in inflight:
            if t.retries_left <= 0:
                log.warning(kv(event="request_dropped", rid=t.request.request_id))
                self._tracked.pop(t.request.request_id, None)
                continue
            t.retries_left -= 1
            eng.submit(t.request)

    def run_until_idle(self, max_ticks: int = 10000) -> List[Result]:
        out: List[Result] = []
        for _ in range(max_ticks):
            if not self._tracked:
                break
            out.extend(self.step())
        return out

    def health(self) -> Dict[str, Dict[str, int]]:
        return {
            k: {
                "active": eng.core.active(),
                "pending": eng.core.pending(),
                "failures": self.failures[k],
            }
            for k, eng in self.engines.items()
        }
