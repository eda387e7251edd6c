"""Observability: request tracing, the flight recorder, and their wiring.

A copy of ``cassmantle_tpu/obs/__init__.py``. :mod:`.trace` holds the
tracer (tail sampling, ``traceparent``), :mod:`.recorder` the event ring
``/debugz`` replays, :mod:`.slo` the burn-rate engine, :mod:`.process`
and :mod:`.device` the process and device samplers; the metrics registry
stays in ``utils/logging.py``. :func:`configure_observability` applies an
``ObsConfig`` to the process-global instances; the server calls it.
"""

from __future__ import annotations

from cassmantle_tpu_torch.obs.recorder import flight_recorder
from cassmantle_tpu_torch.obs.trace import tracer

__all__ = ["tracer", "flight_recorder", "configure_observability"]


def configure_observability(obs_cfg) -> None:
    """Apply an ``ObsConfig`` to the process-global tracer, flight
    recorder and histogram defaults. Idempotent; recorded data is kept (a
    capacity shrink drops the oldest)."""
    from cassmantle_tpu_torch.utils.logging import metrics

    tracer.configure(
        capacity=obs_cfg.trace_capacity,
        sample_rate=obs_cfg.trace_sample_rate,
        max_spans_per_trace=obs_cfg.trace_max_spans,
        pending_capacity=obs_cfg.trace_pending_capacity,
        pending_ttl_s=obs_cfg.trace_pending_ttl_s,
        tail_slow_default_s=obs_cfg.tail_slow_default_s,
        tail_slow_routes=dict(obs_cfg.tail_slow_routes),
    )
    flight_recorder.set_capacity(obs_cfg.recorder_capacity)
    metrics.set_default_buckets(obs_cfg.latency_buckets_s)
