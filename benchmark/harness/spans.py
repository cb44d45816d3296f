"""Host time per traced MD step from the program's spans: the registry
that ``admp_tpu_torch.utils.profiling`` fills while a torch profiler
records, which in a run is the traced sub-window alone. Against a program
without that registry every reading is None."""

from __future__ import annotations

import importlib


def registry():
    """The program's ``snapshot()``, or None where it has none."""
    try:
        profiling = importlib.import_module("admp_tpu_torch.utils.profiling")
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    return snapshot() if callable(snapshot) else None


def host_ms(ctx, names, part="total_ms"):
    """The sum of ``part`` ('total_ms' or 'self_ms') over the spans
    ``names``, per traced step; None without a traced window, a registry
    or any of those spans."""
    t = ctx.get("trace")
    if not t or not t.get("steps"):
        return None
    reg = registry()
    if reg is None:
        return None
    found = [reg["spans"][n][part] for n in names if n in reg["spans"]]
    return sum(found) / t["steps"] if found else None
