"""Request scheduler: admission, chunked prefill interleave, eviction.

Host-side bookkeeping, carried over from the reference unchanged.

Per-request state machine (DESIGN.md §6):

    QUEUED --admit(lease slot)--> PREFILL --prompt consumed--> DECODE
       ^                             |                            |
       +------- evict (arena pressure; keeps generated) ---------+
                                              DECODE --max tokens--> FINISHED

Scheduling is iteration-level (continuous batching): every engine step,
each DECODE-phase request advances one token, and PREFILL-phase
requests advance by a fixed-width prompt chunk — at most
``max_prefill_chunks_per_step`` chunks per step, so long prompts never
stall the decode batch.  A prompt tail shorter than the chunk rides the
decode batch as teacher-forced tokens (same width-1 step, forced feed),
which keeps the prefill-chunk shape static for jit.

Eviction under arena pressure: when the queue head has waited longer
than ``evict_patience`` steps and no slot is free, the most recently
admitted request (with at least ``evict_patience`` steps of residency)
is preempted back to the queue.  Its generated tokens are kept; on
re-admission it re-prefills prompt + generated, so greedy decoding
resumes exactly where it left off (recompute, never lose).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

from repro_torch.serving.slots import SlotPool

QUEUED, PREFILL, DECODE, FINISHED = "QUEUED", "PREFILL", "DECODE", "FINISHED"

# SLO classes: INTERACTIVE requests are latency-bound (a user waits on
# every token), BATCH requests throughput-bound offline work.  The engine
# is SLO-blind; the class rides along for a fleet router.
INTERACTIVE, BATCH = "interactive", "batch"
SLO_CLASSES = (INTERACTIVE, BATCH)


@dataclass(frozen=True)
class Request:
    rid: str
    prompt: tuple                       # token ids
    max_new_tokens: int
    arrival_step: int = 0
    slo: str = INTERACTIVE

    def __post_init__(self):
        object.__setattr__(self, "prompt", tuple(int(t) for t in self.prompt))
        if len(self.prompt) < 1:
            raise ValueError(f"{self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"{self.rid}: max_new_tokens must be >= 1")
        if self.slo not in SLO_CLASSES:
            raise ValueError(f"{self.rid}: unknown SLO class {self.slo!r} "
                             f"(one of {SLO_CLASSES})")


@dataclass
class RequestState:
    req: Request
    phase: str = QUEUED
    slot: Optional[int] = None
    pos: int = 0                        # tokens written into the cache row
    generated: list = field(default_factory=list)
    waiting_since: int = 0              # step enqueued / evicted (starvation)
    joined_step: int = -1               # step of last admission (residency)
    evictions: int = 0

    @property
    def seq(self) -> list:
        """The full teacher-forcing sequence: prompt + generated so far."""
        return list(self.req.prompt) + self.generated

    @property
    def remaining(self) -> int:
        return len(self.req.prompt) + len(self.generated) - self.pos

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.req.max_new_tokens


class Scheduler:
    def __init__(self, pool: SlotPool, *, prefill_chunk: int = 32,
                 max_prefill_chunks_per_step: int = 1,
                 evict_patience: Optional[int] = None):
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.pool = pool
        self.prefill_chunk = prefill_chunk
        self.max_prefill_chunks_per_step = max_prefill_chunks_per_step
        self.evict_patience = evict_patience
        self.queue: deque = deque()     # QUEUED RequestStates
        self.active: dict = {}          # rid -> RequestState (leased)
        self.finished: dict = {}        # rid -> RequestState

    # --- admission / eviction ---------------------------------------------

    def submit(self, req: Request, step: int = 0) -> RequestState:
        if req.rid in self.active or req.rid in self.finished \
                or any(s.req.rid == req.rid for s in self.queue):
            raise ValueError(f"duplicate request id {req.rid!r}")
        st = RequestState(req=req, waiting_since=step)
        self.queue.append(st)
        return st

    def admit(self, step: int) -> list:
        """Lease slots to queued requests (FIFO).  Returns newly joined
        states; the engine must reset their arena rows before use."""
        joined = []
        while self.queue and self.pool.free_count:
            st = self.queue.popleft()
            st.slot = self.pool.lease(st.req.rid)
            st.phase = PREFILL
            st.pos = 0
            st.joined_step = step
            self.active[st.req.rid] = st
            joined.append(st)
        return joined

    def plan_evictions(self, step: int) -> list:
        """Preempt (at most one per step) when the queue head starves.

        The victim is the most recently admitted request that has had at
        least ``evict_patience`` steps of residency — so every admission
        is guaranteed that much progress before it can be preempted.
        The *senior* resident (oldest admission) is never preempted:
        one request always runs to completion, which is what rules out
        the global livelock where every residency is spent re-prefilling
        state that the next eviction throws away.
        """
        if (self.evict_patience is None or not self.queue
                or self.pool.free_count):
            return []
        head = self.queue[0]
        if step - head.waiting_since < self.evict_patience:
            return []
        for slot in self.pool.leased_by_recency()[:-1]:   # senior immune
            victim = self.active[self.pool.owner(slot)]
            if step - victim.joined_step >= self.evict_patience:
                self._evict(victim, step)
                return [victim]
        return []

    def _evict(self, st: RequestState, step: int) -> None:
        self.pool.release(st.slot)
        del self.active[st.req.rid]
        self._requeue(st, step)
        self.queue.append(st)

    @staticmethod
    def _requeue(st: RequestState, step: int) -> None:
        """Reset a state that lost its arena row back to QUEUED: generated
        tokens are KEPT, so re-admission re-prefills prompt + generated
        and greedy decode resumes bit-exactly (the eviction contract)."""
        st.slot = None
        st.phase = QUEUED
        st.pos = 0                      # cache row is gone; re-prefill
        st.waiting_since = step
        st.evictions += 1

    # --- per-step work selection ------------------------------------------

    def chunk_candidates(self) -> list:
        """PREFILL-phase requests with a full chunk of prompt left, oldest
        admission first, capped at ``max_prefill_chunks_per_step``."""
        cands = sorted((s for s in self.active.values()
                        if s.phase == PREFILL
                        and s.remaining >= self.prefill_chunk),
                       key=lambda s: (s.joined_step, s.slot))
        return cands[:self.max_prefill_chunks_per_step]

    def decode_rows(self, chunked: Sequence[RequestState] = ()) -> list:
        """Active rows advancing one token this step: every DECODE-phase
        request plus PREFILL tails shorter than a chunk (teacher-forced).
        Rows already advanced by a chunk this step are excluded."""
        skip = {s.req.rid for s in chunked}
        return [s for s in self.active.values()
                if s.req.rid not in skip
                and (s.phase == DECODE or s.remaining < self.prefill_chunk)]

    def feed_token(self, st: RequestState) -> int:
        return st.seq[st.pos]

    # --- progress ----------------------------------------------------------

    def _advance(self, st: RequestState, n: int, next_tok: int) -> tuple:
        """Consume n fed tokens; append `next_tok` if the sequence is now
        fully consumed.  Returns (appended, finished)."""
        st.pos += n
        total = len(st.req.prompt) + len(st.generated)
        assert st.pos <= total, (st.req.rid, st.pos, total)
        if st.pos < total:
            return False, False
        st.generated.append(int(next_tok))
        if st.phase == PREFILL:
            st.phase = DECODE
        if st.done:
            st.phase = FINISHED
            self.pool.release(st.slot)
            del self.active[st.req.rid]
            self.finished[st.req.rid] = st
            return True, True
        return True, False

    def consume(self, st: RequestState, next_tok: int) -> tuple:
        """One decode-path token was fed (forced or generated)."""
        return self._advance(st, 1, next_tok)

    def consume_chunk(self, st: RequestState, n: int, last_tok: int) -> tuple:
        """A prefill chunk of n tokens was processed; `last_tok` is the
        argmax of the chunk's final-position logits (used only when the
        chunk completes the sequence)."""
        return self._advance(st, n, last_tok)

    def consume_spec(self, st: RequestState, tokens: Sequence[int]) -> tuple:
        """Commit a verified speculative run: `tokens` are the big model's
        argmaxes for the accepted prefix (>= 1 per verify — position 0 is
        teacher-forced, so its output is always kept).

        Equivalent to len(tokens) sequential ``consume`` calls — each
        committed token is one consumed fed token plus one appended
        output, so pos/generated/phase advance exactly as the
        non-speculative loop would.  Returns (appended, finished);
        stops early when max_new_tokens is reached.
        """
        appended = 0
        for t in tokens:
            ok, fin = self._advance(st, 1, int(t))
            appended += int(ok)
            if fin:
                return appended, True
        return appended, False

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active

    def results(self) -> dict:
        return {rid: list(st.generated) for rid, st in self.finished.items()}
