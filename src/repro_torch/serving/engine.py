"""The serving engine: continuous batching over a fixed slot arena.

Two step functions, both under the serving program words:

- the masked width-1 decode over the WHOLE arena (fixed shape) under the
  DECODE word — per-op matvec words, or one fused ``decode_fused`` word
  per layer (``build_engine(fused_decode=True)``).  Inactive rows compute
  garbage that is discarded; their cache rows are left exactly as they
  were because the step writes the cache only on ``active`` rows (the
  reference computes, then restores inactive rows with ``jnp.where``);
- one ``prefill_chunk``-wide prompt chunk for a single slot under the
  PREFILL word (``sr_matmul`` on the cuda backend), run on views of that
  slot's arena row.

An arena row is a request's KV ring (attention) or its recurrent state
(rwkv6: the wkv state and the token shift, continued by every chunk and
decode step and zeroed when the slot is leased again).

On the reference backend both are bit-identical, per request, to
token-by-token decode: the engine changes scheduling, never math.
Speculative decoding and the fleet hooks wait for later slices.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.program import Program, compile_program
from repro_torch.models import transformer as tfm
from repro_torch.runtime import train_loop as tl
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.slots import SlotPool, reset_slots, slot_bytes


@dataclass(frozen=True)
class TokenEvent:
    """One generated token: (request, token id, index within the request's
    output, engine step, wall-clock seconds)."""
    rid: str
    token: int
    index: int
    step: int
    t: float


def _rows(cache, slot: int):
    """Views of one slot's arena row (leaves (n_groups, 1, ...))."""
    if isinstance(cache, dict):
        return {k: _rows(v, slot) for k, v in cache.items()}
    return cache[:, slot:slot + 1]


class ServingEngine:
    """Continuous-batching engine over a fixed slot arena.  ``device``
    None runs on CUDA and raises when there is none; pass device="cpu"
    to run on the CPU (``runtime/train_loop.resolve_device``)."""

    def __init__(self, cfg: ModelConfig, program: Program, params, *,
                 n_slots: int, max_len: int, prefill_chunk: int = 32,
                 kernel_backend: str = "reference", device=None,
                 max_prefill_chunks_per_step: int = 1,
                 evict_patience: Optional[int] = None):
        self.cfg = cfg
        self.program = program
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.device = tl.resolve_device(device)
        self.pool = SlotPool(n_slots)
        self.sched = Scheduler(
            self.pool, prefill_chunk=prefill_chunk,
            max_prefill_chunks_per_step=max_prefill_chunks_per_step,
            evict_patience=evict_patience)
        self.cache = tfm.init_cache(cfg, n_slots, max_len, device=self.device)
        self.step_count = 0
        self.events: list = []
        self.nonfinite_logits = 0      # logits that were inf/NaN, all steps
        self._row_bytes = slot_bytes(cfg, max_len)
        make_decode = (tl.make_fused_decode_step if program.fused_decode
                       else tl.make_decode_step)
        self._decode_fn = make_decode(cfg, program,
                                      kernel_backend=kernel_backend)
        self._chunk_fn = tl.make_chunk_step(cfg, program,
                                            kernel_backend=kernel_backend)

    # --- request intake ----------------------------------------------------

    def submit(self, req: Request) -> None:
        self._validate(req)
        self.sched.submit(req, self.step_count)

    def _validate(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"{req.rid}: prompt({len(req.prompt)}) + "
                f"max_new({req.max_new_tokens}) exceeds max_len={self.max_len}")

    @property
    def arena_row_bytes(self) -> int:
        return self._row_bytes

    # --- the two step functions ----------------------------------------------

    def _argmax(self, logits: torch.Tensor) -> np.ndarray:
        self.nonfinite_logits += int((~torch.isfinite(logits)).sum())
        return torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    def _chunk(self, tokens: np.ndarray, pos0: int, slot: int) -> int:
        dev = self.device
        logits, _ = self._chunk_fn(
            self.params, _rows(self.cache, slot),
            torch.as_tensor(tokens, dtype=torch.int32, device=dev)[None],
            torch.tensor([pos0], dtype=torch.int32, device=dev))
        return int(self._argmax(logits[0, -1]))

    def _decode(self, tok: np.ndarray, pos: np.ndarray,
                active: np.ndarray) -> np.ndarray:
        dev = self.device
        logits, _ = self._decode_fn(
            self.params, self.cache,
            torch.as_tensor(tok, device=dev), torch.as_tensor(pos, device=dev),
            torch.as_tensor(active, device=dev))
        return self._argmax(logits[:, 0])

    # --- one engine iteration ----------------------------------------------

    def step(self) -> list:
        """One continuous-batching iteration: evict / admit / chunk-prefill
        / masked arena decode.  Returns the TokenEvents of this step."""
        step = self.step_count
        self.step_count += 1
        new_events: list = []

        self.sched.plan_evictions(step)
        for st in self.sched.admit(step):
            reset_slots(self.cache, [st.slot])

        chunked = self.sched.chunk_candidates()
        for st in chunked:
            toks = np.asarray(st.seq[st.pos:st.pos + self.prefill_chunk],
                              np.int32)
            last = self._chunk(toks, st.pos, st.slot)
            appended, _ = self.sched.consume_chunk(st, self.prefill_chunk,
                                                   last)
            if appended:
                new_events.append(self._event(st, step))

        # masked width-1 decode over the whole arena: DECODE-phase rows
        # feed their last token, sub-chunk PREFILL tails are teacher-forced
        rows = self.sched.decode_rows(chunked)
        if rows:
            tok = np.zeros((self.n_slots, 1), np.int32)
            pos = np.zeros((self.n_slots,), np.int32)
            active = np.zeros((self.n_slots,), bool)
            for st in rows:
                tok[st.slot, 0] = self.sched.feed_token(st)
                pos[st.slot] = st.pos
                active[st.slot] = True
            nxt = self._decode(tok, pos, active)
            for st in rows:
                appended, _ = self.sched.consume(st, int(nxt[st.slot]))
                if appended:
                    new_events.append(self._event(st, step))

        self.events.extend(new_events)
        return new_events

    def _event(self, st, step: int) -> TokenEvent:
        return TokenEvent(rid=st.req.rid, token=st.generated[-1],
                          index=len(st.generated) - 1, step=step,
                          t=time.monotonic())

    def run(self, requests=(), max_steps: int = 1_000_000) -> dict:
        """Feed `requests` at their arrival steps and run until drained.
        Returns {rid: generated token list}."""
        pending = sorted(requests, key=lambda r: (r.arrival_step, r.rid))
        for r in pending:
            self._validate(r)
        i = 0
        for _ in range(max_steps):
            while i < len(pending) \
                    and pending[i].arrival_step <= self.step_count:
                self.submit(pending[i])
                i += 1
            if i == len(pending) and self.sched.idle:
                return self.sched.results()
            self.step()
        raise RuntimeError(f"engine did not drain in {max_steps} steps")


def build_engine(cfg: ModelConfig, *, n_slots: int, max_len: int,
                 prefill_chunk: int = 32, kernel_backend: str = "reference",
                 seed: int = 0, fused_decode: bool = False, device=None,
                 params: Optional[dict] = None,
                 **engine_kwargs) -> ServingEngine:
    """Compile the serve program, init bf16 params from a seeded
    ``torch.Generator`` (or take `params`), build the engine.

    device=None runs on CUDA and raises when there is none; pass
    device="cpu" to run on the CPU.
    """
    dev = tl.resolve_device(device)
    shape = ShapeConfig("serve", seq_len=max_len, global_batch=n_slots,
                        kind="decode")
    program = compile_program(cfg, shape, fused_decode=fused_decode)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = tl.cast_params(tfm.init(gen, cfg), torch.bfloat16)
    return ServingEngine(cfg, program, params, n_slots=n_slots,
                         max_len=max_len, prefill_chunk=prefill_chunk,
                         kernel_backend=kernel_backend, device=dev,
                         **engine_kwargs)


def latency_stats(events) -> dict:
    """Throughput + per-token latency (the gap between a request's
    consecutive tokens) over a run's TokenEvents."""
    if not events:
        return {"tokens": 0, "wall_s": 0.0, "tok_s": 0.0,
                "p50_ms": 0.0, "p99_ms": 0.0}
    by_rid: dict = {}
    for e in events:
        by_rid.setdefault(e.rid, []).append(e)
    gaps = []
    for evs in by_rid.values():
        evs = sorted(evs, key=lambda e: e.index)
        gaps += [b.t - a.t for a, b in zip(evs, evs[1:])]
    wall = max(e.t for e in events) - min(e.t for e in events)
    n = len(events)
    gaps.sort()
    pick = (lambda q: gaps[min(len(gaps) - 1, int(q * len(gaps)))]) if gaps \
        else (lambda q: 0.0)
    return {"tokens": n, "wall_s": wall,
            "tok_s": n / wall if wall > 0 else float("inf"),
            "p50_ms": pick(0.50) * 1e3, "p99_ms": pick(0.99) * 1e3}
