"""Deterministic fault injection (a copy of ``cassmantle_tpu/chaos``).

``fault_point`` (and its awaitable twin ``afault_point``) is the
no-op-unless-armed hook at the serving seam's
boundaries; ``configure`` arms a seeded plan from a spec string
(``configure_from_env``: ``CASSMANTLE_CHAOS`` or the config's;
``disarm`` drops it; ``plan`` is the armed plan, ``release`` ends a
wedge); ``status()`` describes the armed plan.
"""

from cassmantle_tpu_torch.chaos.core import (
    CHAOS_ENV,
    FAULT_POINTS,
    KINDS,
    ChaosInjected,
    ChaosPartition,
    ChaosPlan,
    ChaosRule,
    afault_point,
    armed,
    configure,
    configure_from_env,
    disarm,
    fault_point,
    parse_spec,
    plan,
    release,
    status,
)

__all__ = [
    "CHAOS_ENV",
    "FAULT_POINTS",
    "KINDS",
    "ChaosInjected",
    "ChaosPartition",
    "ChaosPlan",
    "ChaosRule",
    "afault_point",
    "armed",
    "configure",
    "configure_from_env",
    "disarm",
    "fault_point",
    "parse_spec",
    "plan",
    "release",
    "status",
]
