"""Serving engine: model steps as rFaaS functions (DESIGN.md §3).

``ModelServer`` is the executor-side state: the model's prefill/decode
steps plus per-session KV caches that stay RESIDENT on the server between
invocations (the client ships only the new tokens, never the cache).
Decode updates the resident cache in place, the counterpart of the
reference's donated cache buffer.  Results come back as host numpy.

``ServeEngine`` is the client: it leases workers through the Invoker,
pushes the model function library, and drives wave-scheduled batched
generation with per-request latency accounting and optional straggler
backup requests for stateless functions.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import FunctionLibrary, Invoker
from repro_torch.core.clock import Clock

_session_ids = itertools.count(1)


class ModelServer:
    """Executor-side function bundle for one model.  The device is the
    params' device."""

    def __init__(self, model, params, *, max_len: int = 256):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.device = params["embed"]["tokens"].device
        self._sessions: Dict[int, tuple] = {}       # sid -> (cache, length)
        self._lock = threading.Lock()

    def _tokens(self, payload) -> torch.Tensor:
        return torch.as_tensor(np.asarray(payload["tokens"]),
                               device=self.device).long()

    @staticmethod
    def _next_token(logits) -> np.ndarray:
        return logits[:, -1].argmax(dim=-1).to(torch.int32).cpu().numpy()

    # ------------------------------------------------- executor functions
    # Each runs on an executor worker thread; grad mode is thread-local,
    # so each enters inference mode itself.
    def prefill(self, payload: dict) -> dict:
        """payload: {"tokens": (b, s) int}.  Creates a resident session;
        the cache NEVER travels back to the client (zero-copy residency)."""
        with torch.inference_mode():
            logits, cache, length = self.model.prefill(
                self.params, self._tokens(payload), self.max_len)
            next_tok = self._next_token(logits)
        sid = next(_session_ids)
        with self._lock:
            self._sessions[sid] = (cache, length)
        return {"sid": sid, "next_token": next_tok}

    def decode(self, payload: dict) -> dict:
        """payload: {"sid": int, "tokens": (b, 1) int} -> next token.
        Hot path: resident cache, updated in place."""
        sid = int(payload["sid"])
        with self._lock:
            cache, length = self._sessions.pop(sid)
        with torch.inference_mode():
            logits, cache, length = self.model.decode(
                self.params, cache, self._tokens(payload), length)
            next_tok = self._next_token(logits)
        with self._lock:
            self._sessions[sid] = (cache, length)
        return {"sid": sid, "next_token": next_tok}

    def close_session(self, payload: dict) -> dict:
        with self._lock:
            self._sessions.pop(int(payload["sid"]), None)
        return {"ok": True}

    def make_library(self, name: str = "llm") -> FunctionLibrary:
        lib = FunctionLibrary(name, code_size=1 << 20)
        lib.register("prefill", self.prefill)
        lib.register("decode", self.decode)
        lib.register("close_session", self.close_session)
        return lib


@dataclass
class GenRequest:
    prompt: np.ndarray                       # (s,) int32
    max_new_tokens: int = 16
    request_id: int = 0
    t_enqueue: float = 0.0
    tokens_out: List[int] = field(default_factory=list)
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        return (None if self.t_first_token is None
                else self.t_first_token - self.t_enqueue)

    @property
    def latency(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_enqueue


class ServeEngine:
    """Client-side wave-batched generation over leased rFaaS workers."""

    def __init__(self, invoker: Invoker, *, batch_size: int = 4,
                 eos_token: int = -1, clock: Optional[Clock] = None):
        self.invoker = invoker
        self.batch_size = batch_size
        self.eos_token = eos_token
        # default to the invoker's clock: request timestamps must live
        # on the same timeline the invocations complete on
        self.clock = invoker.clock if clock is None else clock
        self._queue: List[GenRequest] = []
        self._rid = itertools.count(1)
        self.completed: List[GenRequest] = []

    def enqueue(self, prompt, max_new_tokens: int = 16) -> GenRequest:
        req = GenRequest(np.asarray(prompt, np.int32), max_new_tokens,
                         next(self._rid), self.clock.now())
        self._queue.append(req)
        return req

    def run(self) -> List[GenRequest]:
        """Drain the queue in waves of ``batch_size``."""
        while self._queue:
            wave, self._queue = (self._queue[:self.batch_size],
                                 self._queue[self.batch_size:])
            self._run_wave(wave)
        return self.completed

    def _run_wave(self, wave: List[GenRequest]):
        # left-pad prompts to a common length with token 0
        s = max(len(r.prompt) for r in wave)
        toks = np.zeros((len(wave), s), np.int32)
        for i, r in enumerate(wave):
            toks[i, s - len(r.prompt):] = r.prompt
        out = self.invoker.invoke("prefill", {"tokens": toks})
        sid = out["sid"]
        nxt = out["next_token"]
        now = self.clock.now()
        for i, r in enumerate(wave):
            r.tokens_out.append(int(nxt[i]))
            r.t_first_token = now
        max_new = max(r.max_new_tokens for r in wave)
        for step in range(1, max_new):
            out = self.invoker.invoke(
                "decode", {"sid": sid, "tokens": nxt[:, None]})
            nxt = out["next_token"]
            now = self.clock.now()
            for i, r in enumerate(wave):
                if len(r.tokens_out) < r.max_new_tokens and \
                        (not r.tokens_out
                         or r.tokens_out[-1] != self.eos_token):
                    r.tokens_out.append(int(nxt[i]))
                    if len(r.tokens_out) >= r.max_new_tokens:
                        r.t_done = now
        now = self.clock.now()
        for r in wave:
            if r.t_done is None:
                r.t_done = now
        self.invoker.invoke("close_session", {"sid": sid})
        self.completed.extend(wave)

    # ------------------------------------------------------------ metrics
    def metrics(self) -> dict:
        lats = [r.latency for r in self.completed if r.latency is not None]
        ttfts = [r.ttft for r in self.completed if r.ttft is not None]
        toks = sum(len(r.tokens_out) for r in self.completed)
        span = (max(r.t_done for r in self.completed)
                - min(r.t_enqueue for r in self.completed)
                if self.completed else 0.0)
        wire = self.invoker.transport_stats()    # DESIGN.md §12
        return {
            "requests": len(self.completed),
            "tokens": toks,
            "throughput_tok_s": toks / span if span else 0.0,
            "p50_latency_s": float(np.median(lats)) if lats else 0.0,
            "p99_latency_s": float(np.percentile(lats, 99)) if lats else 0.0,
            "p50_ttft_s": float(np.median(ttfts)) if ttfts else 0.0,
            # wire activity of the serving session: tokens ship as
            # channel messages, so cost-per-token is auditable
            "net_messages": wire["messages"],
            "net_bytes": wire["bytes"],
        }


def backup_submit(invoker: Invoker, fn_name: str, payload,
                  deadline_s: float, clock: Optional[Clock] = None):
    """Straggler mitigation for STATELESS functions: duplicate dispatch
    after a deadline, first result wins (DESIGN.md §9).  Deadline
    polling runs on the invoker's clock (overridable), so simulated
    deadlines neither sleep nor drift."""
    clock = invoker.clock if clock is None else clock
    f1 = invoker.submit(fn_name, payload)
    t0 = clock.now()
    while not f1.done() and clock.now() - t0 < deadline_s:
        clock.sleep(deadline_s / 50)
    if f1.done():
        return f1.get(0.0), False
    f2 = invoker.submit(fn_name, payload)          # backup request
    while True:
        if f1.done():
            return f1.get(0.0), False
        if f2.done():
            return f2.get(0.0), True
        clock.sleep(deadline_s / 50)
