"""The one global on/off switch for the telemetry plane.

A copy of `repro.obs._state` (numpy + stdlib).

Every instrument's hot-path method begins with a read of the module
attribute `on` — a single no-op attribute check is ALL a disabled plane
costs; results stay bit-identical with it off
(tests/test_torch_obs.py).
`REPRO_OBS=0` disables collection for the whole process at import;
`enable()`/`disable()` flip it at runtime (tests, A/B overhead runs).
"""
from __future__ import annotations

import os

_OFF_VALUES = ("0", "false", "off", "no")

on: bool = os.environ.get("REPRO_OBS", "1").strip().lower() \
    not in _OFF_VALUES


def enable() -> bool:
    """Turn collection on; returns the previous setting."""
    global on
    prev, on = on, True
    return prev


def disable() -> bool:
    """Turn collection off; returns the previous setting."""
    global on
    prev, on = on, False
    return prev


def set_enabled(value: bool) -> bool:
    """Set the switch directly; returns the previous setting."""
    global on
    prev, on = on, bool(value)
    return prev
