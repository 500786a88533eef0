"""Continuous-batching serving: slot arena, scheduler, traces, engine."""
from repro_torch.serving.engine import (ServingEngine, TokenEvent,
                                        build_engine, latency_stats)
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.trace import poisson_trace

__all__ = ["ServingEngine", "TokenEvent", "build_engine", "latency_stats",
           "Request", "Scheduler", "poisson_trace"]
