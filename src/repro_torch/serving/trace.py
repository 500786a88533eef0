"""Synthetic request traces for the serving examples and benchmarks.

Poisson arrivals (exponential inter-arrival gaps, quantised to engine
steps), log-uniform-ish prompt lengths in a [lo, hi] band, random token
ids.  Deterministic per seed — the parity tests replay the same trace
through the engine and the single-shot oracle.

The reference's numpy generator, carried over unchanged: the same seed
gives the same requests in both packages.  The bursty and diurnal
generators wait for the fleet slice.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serving.scheduler import Request


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
