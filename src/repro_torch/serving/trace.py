"""Synthetic request traces for the serving examples and benchmarks.

Poisson arrivals (exponential inter-arrival gaps, quantised to engine
steps), log-uniform-ish prompt lengths in a [lo, hi] band, random token
ids.  Deterministic per seed — the parity tests replay the same trace
through the engine and the single-shot oracle.

Three generators, in rising realism:

- :func:`poisson_trace` — memoryless steady state (the optimist's load).
- :func:`bursty_trace` — whole bursts land on one step (retries, fan-out
  callers, batch jobs synchronising).
- :func:`diurnal_trace` — a day-shaped rate curve with heavy-tailed
  inter-arrival gaps, an interactive/batch SLO mix, and a pool of shared
  prompt heads (system prompts, few-shot preambles).

The reference's numpy generators, carried over unchanged: the same
arguments give the same requests in both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serving.scheduler import BATCH, INTERACTIVE, Request


def _prompt_len(rng, lo: int, hi: int) -> int:
    """One log-uniform prompt length clamped to the [lo, hi] band (short
    interactive prompts and long documents both appear)."""
    plen = int(round(np.exp(rng.uniform(np.log(lo), np.log(hi)))))
    return max(lo, min(hi, plen))


def poisson_trace(n_requests: int, *, vocab_size: int,
                  prompt_lens: tuple = (16, 512), gen_tokens: int = 32,
                  mean_interarrival_steps: float = 2.0,
                  seed: int = 0) -> list:
    """A list of Requests with Poisson arrival steps.

    prompt_lens: inclusive (lo, hi) band; lengths are drawn log-uniform
    so short interactive prompts and long documents both appear.
    """
    lo, hi = prompt_lens
    if not 1 <= lo <= hi:
        raise ValueError(f"bad prompt_lens {prompt_lens}")
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs = []
    for i in range(n_requests):
        t += rng.exponential(mean_interarrival_steps)
        plen = _prompt_len(rng, lo, hi)
        prompt = rng.integers(0, vocab_size, size=plen)
        reqs.append(Request(rid=f"req-{i:04d}", prompt=tuple(int(x) for x in prompt),
                            max_new_tokens=gen_tokens, arrival_step=int(t)))
    return reqs


def bursty_trace(n_requests: int, *, vocab_size: int,
                 prompt_lens: tuple = (16, 512), gen_tokens: int = 32,
                 burst_size: int = 4, burst_gap_steps: int = 16,
                 seed: int = 0) -> list:
    """Bursty arrivals: whole bursts land on ONE step, then silence.

    Production traffic is not Poisson — retries, fan-out callers and
    batch jobs synchronise, so requests arrive in clumps that oversubscribe
    the slot arena all at once and then leave it idle.  Every
    ``burst_gap_steps`` (jittered ±25% per burst) a burst of
    ``burst_size`` requests (last burst truncated) arrives on the same
    step: the overload case, and the trace that actually exercises
    queueing + eviction.

    Same prompt-length band and determinism contract as
    :func:`poisson_trace`.
    """
    lo, hi = prompt_lens
    if not 1 <= lo <= hi:
        raise ValueError(f"bad prompt_lens {prompt_lens}")
    if burst_size < 1 or burst_gap_steps < 1:
        raise ValueError(f"bad burst shape ({burst_size}, {burst_gap_steps})")
    rng = np.random.default_rng(seed)
    reqs = []
    t = 0
    i = 0
    while i < n_requests:
        for _ in range(min(burst_size, n_requests - i)):
            plen = _prompt_len(rng, lo, hi)
            prompt = rng.integers(0, vocab_size, size=plen)
            reqs.append(Request(rid=f"req-{i:04d}",
                                prompt=tuple(int(x) for x in prompt),
                                max_new_tokens=gen_tokens, arrival_step=t))
            i += 1
        t += max(1, int(round(burst_gap_steps
                              * rng.uniform(0.75, 1.25))))
    return reqs


def diurnal_trace(n_requests: int, *, vocab_size: int,
                  prompt_lens: tuple = (16, 512), gen_tokens: int = 32,
                  period_steps: int = 64,
                  peak_interarrival_steps: float = 0.5,
                  trough_interarrival_steps: float = 8.0,
                  tail_prob: float = 0.05, tail_shape: float = 1.5,
                  batch_frac: float = 0.0,
                  prefix_pool: int = 0, prefix_len: int = 0,
                  day_phase: float = 0.0,
                  seed: int = 0) -> list:
    """Diurnal + heavy-tail arrivals with SLO classes and shared heads.

    The arrival rate follows a day-shaped cosine: the mean inter-arrival
    gap interpolates log-linearly between ``peak_interarrival_steps``
    (rush hour) and ``trough_interarrival_steps`` (3am) over
    ``period_steps``.  Gaps are exponential at the instantaneous rate,
    except a ``tail_prob`` fraction are multiplied by a Pareto(
    ``tail_shape``) draw — shape < 2 gives the infinite-variance lull
    tail real traffic shows (a Poisson fit under-predicts both the
    clumps and the silences).

    Each request is BATCH with probability ``batch_frac`` (else
    INTERACTIVE) — the admission-control mix.  With ``prefix_pool`` > 0,
    every request's prompt starts with one of ``prefix_pool`` shared
    heads of ``prefix_len`` tokens (drawn with a quadratic skew, so a
    few heads dominate like production system prompts do) followed by a
    unique tail (what a prefix cache would prefill once).

    ``day_phase`` shifts where in the day the trace starts, as a
    fraction of ``period_steps``: 0.0 starts at rush hour, 0.5 at the
    3am trough (a ramp to climb for an autoscaler).

    Same determinism contract as :func:`poisson_trace`: the request
    list, classes and heads are a pure function of the arguments.
    """
    lo, hi = prompt_lens
    if not 1 <= lo <= hi:
        raise ValueError(f"bad prompt_lens {prompt_lens}")
    if prefix_pool and not 0 < prefix_len < hi:
        raise ValueError(
            f"prefix_len must be in (0, {hi}) with prefix_pool, "
            f"got {prefix_len}")
    if not 0.0 < peak_interarrival_steps <= trough_interarrival_steps:
        raise ValueError("need 0 < peak_interarrival <= trough_interarrival")
    if not 0.0 <= day_phase < 1.0:
        raise ValueError(f"day_phase must be in [0, 1), got {day_phase}")
    rng = np.random.default_rng(seed)
    heads = [tuple(int(x) for x in rng.integers(0, vocab_size,
                                                size=prefix_len))
             for _ in range(prefix_pool)]
    log_peak = np.log(peak_interarrival_steps)
    log_trough = np.log(trough_interarrival_steps)
    t = 0.0
    reqs = []
    for i in range(n_requests):
        # day position in [0, 1): 0 = peak, 0.5 = trough
        day = (t / period_steps + day_phase) % 1.0
        mix = 0.5 - 0.5 * np.cos(2.0 * np.pi * day)      # 0 @ peak, 1 @ trough
        mean_gap = float(np.exp(log_peak + mix * (log_trough - log_peak)))
        gap = rng.exponential(mean_gap)
        if rng.uniform() < tail_prob:
            gap *= rng.pareto(tail_shape) + 1.0
        t += gap
        plen = _prompt_len(rng, lo, hi)
        if heads:
            plen = max(plen, prefix_len + 1)             # a tail must remain
            head = heads[int(prefix_pool * rng.uniform() ** 2)]
            tail = rng.integers(0, vocab_size, size=plen - prefix_len)
            prompt = head + tuple(int(x) for x in tail)
        else:
            prompt = tuple(int(x) for x in
                           rng.integers(0, vocab_size, size=plen))
        slo = BATCH if rng.uniform() < batch_frac else INTERACTIVE
        reqs.append(Request(rid=f"req-{i:04d}", prompt=prompt,
                            max_new_tokens=gen_tokens, arrival_step=int(t),
                            slo=slo))
    return reqs
