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

An arena row holds, unit by unit, a request's KV ring (attention) or its
recurrent state (rwkv6: the wkv state and the token shift; Mamba: the
conv rows and the SSM state), continued by every chunk and decode step
and reset when the slot is leased again.

On the reference backend both are bit-identical, per request, to
token-by-token decode: the engine changes scheduling, never math.

Speculative decoding (``build_engine(speculative=k)``): a small draft
model proposes k-1 tokens under the DRAFT word, one masked width-1 step
over the whole draft arena at a time; the big model verifies all k feeds
in ONE PREFILL-shaped chunk, and the accepted prefix is replayed into
the slot's row as a chunk.  Greedy argmax and chunk == sequential make
the committed tokens bit-identical to the non-speculative loop on the
reference backend; acceptance only changes how many steps it takes.
The chunk step writes its cache in place, so the verify runs on a copy
of the slot's row (the arena is left as it was), and the draft row is
copied out before the proposals and copied back after them.  The fleet
hooks wait for a later slice.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.program import Program, compile_program
from repro_torch.models import transformer as tfm
from repro_torch.runtime import train_loop as tl
from repro_torch.serving.scheduler import DECODE, Request, Scheduler
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


def _copy_(dst, src):
    """Copy every leaf of `src` into the same leaf of `dst`, in place;
    returns dst."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            _copy_(v, src[k])
        return dst
    dst.copy_(src)
    return dst


class ServingEngine:
    """Continuous-batching engine over a fixed slot arena.  ``device``
    None runs on CUDA and raises when there is none; pass device="cpu"
    to run on the CPU (``runtime/train_loop.resolve_device``)."""

    def __init__(self, cfg: ModelConfig, program: Program, params, *,
                 n_slots: int, max_len: int, prefill_chunk: int = 32,
                 kernel_backend: str = "reference", device=None,
                 max_prefill_chunks_per_step: int = 1,
                 evict_patience: Optional[int] = None,
                 speculative: int = 0, draft_cfg: Optional[ModelConfig] = None,
                 draft_program: Optional[Program] = None, draft_params=None):
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

        # --- speculative machinery (opt-in) ---
        self.speculative = int(speculative)
        self.spec_stats = {"verifies": 0, "accepted": 0}
        if self.speculative:
            if draft_program is None or draft_cfg is None \
                    or draft_params is None:
                raise ValueError(
                    "speculative>0 needs a draft (cfg, program, params) — "
                    "build_engine(speculative=k) assembles one")
            self.draft_cfg = draft_cfg
            self.draft_program = draft_program
            self.draft_params = draft_params
            self.draft_cache = tfm.init_cache(draft_cfg, n_slots, max_len,
                                              device=self.device)
            self._draft_pos: dict = {}   # rid -> seq tokens in draft cache
            self._draft_fn = tl.make_draft_step(
                draft_cfg, draft_program, kernel_backend=kernel_backend)
            # one row of each arena: the verify chunk runs on a copy of
            # the slot's row, the draft row is snapshotted here
            self._verify_row = tfm.init_cache(cfg, 1, max_len,
                                              device=self.device)
            self._draft_snap = tfm.init_cache(draft_cfg, 1, max_len,
                                              device=self.device)

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

    def _run_chunk(self, tokens: np.ndarray, pos0: int, row: dict):
        """One chunk over `tokens` from position pos0 on the cache `row`
        (leaves (n_groups, 1, ...), written in place); returns its logits
        (1, T, V)."""
        dev = self.device
        logits, _ = self._chunk_fn(
            self.params, row,
            torch.as_tensor(tokens, dtype=torch.int32, device=dev)[None],
            torch.tensor([pos0], dtype=torch.int32, device=dev))
        return logits

    def _chunk(self, tokens: np.ndarray, pos0: int, slot: int) -> int:
        logits = self._run_chunk(tokens, pos0, _rows(self.cache, slot))
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
            if self.speculative:
                reset_slots(self.draft_cache, [st.slot])
                self._draft_pos[st.req.rid] = 0

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
        spec_rows: list = []
        if self.speculative:
            # DECODE-phase rows take the draft / verify path; PREFILL
            # tails stay teacher-forced on the masked decode
            spec_rows = [s for s in rows if s.phase == DECODE]
            rows = [s for s in rows if s.phase != DECODE]
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

        for st in spec_rows:
            new_events.extend(self._spec_round(st, step))

        self.events.extend(new_events)
        return new_events

    # --- speculative round --------------------------------------------------

    def _draft_step_one(self, tok: int, pos: int, slot: int,
                        read: bool = True) -> Optional[int]:
        """One masked width-1 DRAFT step over the whole draft arena, for
        the one row `slot`; returns the draft's argmax there (read=False:
        a catch-up step, whose logits nothing reads)."""
        dev = self.device
        tokv = np.zeros((self.n_slots, 1), np.int32)
        posv = np.zeros((self.n_slots,), np.int32)
        act = np.zeros((self.n_slots,), bool)
        tokv[slot, 0], posv[slot], act[slot] = tok, pos, True
        logits, _ = self._draft_fn(
            self.draft_params, self.draft_cache,
            torch.as_tensor(tokv, device=dev),
            torch.as_tensor(posv, device=dev),
            torch.as_tensor(act, device=dev))
        return int(self._argmax(logits[slot, 0])) if read else None

    def _verify(self, tokens: np.ndarray, pos0: int, slot: int) -> list:
        """The big model's argmax at every position of one chunk over
        `tokens`, run on a copy of the slot's arena row: the chunk step
        writes its cache in place, and the arena must stay as it was
        (acceptance decides what is replayed into it)."""
        row = _copy_(self._verify_row, _rows(self.cache, slot))
        logits = self._run_chunk(tokens, pos0, row)
        return [int(x) for x in self._argmax(logits[0])]

    def _replay(self, tokens: np.ndarray, pos0: int, slot: int) -> None:
        """The accepted feeds into the slot's row: the committed write
        (their logits were the verify's, so none is read)."""
        self._run_chunk(tokens, pos0, _rows(self.cache, slot))

    def _spec_round(self, st, step: int) -> list:
        """Draft proposals, verify all feeds in one chunk, commit the
        accepted prefix.

        Greedy and chunk == sequential make every committed token
        bit-identical to the non-speculative loop: chunk logits at
        position i depend only on feeds <= i, and a proposal is accepted
        only when it equals the big model's own argmax at its position —
        so the accepted feeds ARE the sequential feeds.  Rollback: the
        verify never writes the arena, the accepted feeds are replayed
        as one chunk, and the draft row is copied back to its snapshot
        and caught up from the true sequence next round (an rwkv6 draft's
        recurrent state cannot be partly rolled back, so the draft never
        keeps speculative state).  The proposals stop at the request's
        budget: a verify position at or past ``max_len`` would wrap the
        KV ring onto the row's first entries and change the logits of
        the positions before it.
        """
        rid, slot, p = st.req.rid, st.slot, st.pos
        seq = st.seq
        feed = seq[p]                    # remaining == 1 in DECODE phase
        budget = st.req.max_new_tokens - len(st.generated)

        # draft catch-up: teacher-force the suffix the draft hasn't seen
        for q in range(self._draft_pos.get(rid, 0), p):
            self._draft_step_one(seq[q], q, slot, False)
        self._draft_pos[rid] = p
        _copy_(self._draft_snap, _rows(self.draft_cache, slot))

        # greedy proposals under the DRAFT word
        props: list = []
        cur = feed
        for i in range(min(self.speculative, budget) - 1):
            cur = self._draft_step_one(cur, p + i, slot)
            props.append(cur)

        # one PREFILL-shaped verify chunk over [feed, d1, ...]
        vt = self._verify(np.asarray([feed] + props, np.int32), p, slot)

        # accepted prefix: proposal i survives iff it IS the big model's
        # argmax at its position; position 0 (teacher-forced) always lands
        a = 0
        while a < len(props) and props[a] == vt[a]:
            a += 1
        commit = vt[:a + 1]

        # replay the accepted feeds into the arena (the committed write)
        self._replay(np.asarray([feed] + commit[:-1], np.int32), p, slot)

        # restore the draft row: proposals were speculative state
        _copy_(_rows(self.draft_cache, slot), self._draft_snap)

        appended, fin = self.sched.consume_spec(st, commit)
        self.spec_stats["verifies"] += 1
        self.spec_stats["accepted"] += appended
        if fin:
            self._draft_pos.pop(rid, None)
        base = len(st.generated) - appended
        return [TokenEvent(rid=rid, token=st.generated[base + j],
                           index=base + j, step=step, t=time.monotonic())
                for j in range(appended)]

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


def draft_config_for(cfg: ModelConfig) -> ModelConfig:
    """The default speculative draft: one scan group of the big model —
    its token space and layer-pattern period, every repeated group
    dropped."""
    period = len(tfm.layer_pattern(cfg))
    return dataclasses.replace(cfg, name=cfg.name + "-draft",
                               n_layers=period)


def _init_bf16(cfg: ModelConfig, seed: int, dev) -> dict:
    """bf16 parameters from a generator seeded with `seed`: each leaf
    drawn in f32 and cast as it is drawn (the bits of a cast of the whole
    f32 tree, which never exists: jamba's 8 layers are 49.5 GiB in f32)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tfm.init(gen, cfg, dtype=torch.bfloat16)


def build_engine(cfg: ModelConfig, *, n_slots: int, max_len: int,
                 prefill_chunk: int = 32, kernel_backend: str = "reference",
                 seed: int = 0, fused_decode: bool = False, device=None,
                 params: Optional[dict] = None, speculative: int = 0,
                 draft_cfg: Optional[ModelConfig] = None,
                 draft_seed: Optional[int] = None,
                 draft_params: Optional[dict] = None,
                 **engine_kwargs) -> ServingEngine:
    """Compile the serve program, init bf16 params from a seeded
    ``torch.Generator`` (or take `params`), build the engine.

    speculative=k runs the draft / verify loop with a k-token window:
    ``draft_cfg`` defaults to :func:`draft_config_for` (one scan group),
    its params drawn from a generator seeded with seed + 1, or
    ``draft_seed`` (draft_cfg=cfg with draft_seed=seed makes the draft
    the big model itself: the full-acceptance oracle), or taken from
    `draft_params`.

    device=None runs on CUDA and raises when there is none; pass
    device="cpu" to run on the CPU.  A model with a Mamba unit serves
    without speculation only: its default draft would be a whole period
    of the pattern (jamba's 8 layers), and the draft / verify loop over a
    Mamba state waits for the speculative Mamba slice
    (NotImplementedError).
    """
    if speculative and tfm.has_mamba(cfg):
        raise NotImplementedError(
            f"{cfg.name}: speculative serving of a model with a Mamba unit "
            f"comes with the speculative Mamba slice")
    dev = tl.resolve_device(device)
    shape = ShapeConfig("serve", seq_len=max_len, global_batch=n_slots,
                        kind="decode")
    program = compile_program(cfg, shape, fused_decode=fused_decode,
                              speculative=bool(speculative))
    if params is None:
        params = _init_bf16(cfg, seed, dev)
    if speculative:
        draft_cfg = draft_cfg or draft_config_for(cfg)
        draft_shape = ShapeConfig("serve-draft", seq_len=max_len,
                                  global_batch=n_slots, kind="decode")
        if draft_params is None:
            draft_params = _init_bf16(
                draft_cfg, seed + 1 if draft_seed is None else draft_seed,
                dev)
        engine_kwargs.update(
            speculative=speculative, draft_cfg=draft_cfg,
            draft_program=compile_program(draft_cfg, draft_shape,
                                          speculative=True),
            draft_params=draft_params)
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
