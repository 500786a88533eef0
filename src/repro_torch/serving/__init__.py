"""Continuous-batching serving: slot arena, scheduler, traces, engine
(with the speculative draft / verify loop, ``build_engine(speculative=k)``)."""
from repro_torch.serving.engine import (ServingEngine, TokenEvent,
                                        build_engine, draft_config_for,
                                        latency_stats)
from repro_torch.serving.scheduler import (BATCH, INTERACTIVE, SLO_CLASSES,
                                           Request, RequestState, Scheduler)
from repro_torch.serving.slots import SlotPool, reset_slots, slot_bytes
from repro_torch.serving.trace import (bursty_trace, diurnal_trace,
                                       poisson_trace)

__all__ = ["ServingEngine", "TokenEvent", "build_engine", "draft_config_for",
           "latency_stats", "Request", "RequestState", "Scheduler",
           "SlotPool", "slot_bytes", "reset_slots", "poisson_trace",
           "bursty_trace", "diurnal_trace", "INTERACTIVE", "BATCH",
           "SLO_CLASSES"]
