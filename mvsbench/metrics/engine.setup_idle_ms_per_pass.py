"""Device idle ms a traced pass while the host is in the self time of the
program's ``engine/setup`` span (uploads, cost and geometric contexts,
edge and label distances, detail demotion, the initial plane and cost), by
exact overlap with the device's gaps (``program_spans.py``)."""

from mvsbench.program_spans import stage_idle_ms


def read(rec):
    return stage_idle_ms(rec, "engine.setup_idle_ms_per_pass")
