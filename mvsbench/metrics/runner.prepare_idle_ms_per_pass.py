"""Device idle ms a traced pass while the host is in the self time of the
program's ``runner/prepare`` span (resizes, cameras, state and source-depth
rescales), by exact overlap with the device's gaps (``program_spans.py``)."""

from mvsbench.program_spans import stage_idle_ms


def read(rec):
    return stage_idle_ms(rec, "runner.prepare_idle_ms_per_pass")
