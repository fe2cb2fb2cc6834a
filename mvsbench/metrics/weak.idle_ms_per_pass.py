"""Device idle ms a traced pass while the host is in the self time of the
program's weak-machinery spans (``weak/anchors``, ``weak/fit`` and the
``weak/propagate`` half-iterations), by exact overlap with the device's
gaps (``program_spans.py``); nothing where no pass runs them."""

from mvsbench.program_spans import stage_idle_ms


def read(rec):
    return stage_idle_ms(rec, "weak.idle_ms_per_pass")
