"""Device idle ms a traced pass while the host is in the self time of the
program's ``runner/priors`` span (Canny edges and label maps, or their
cache, and their rescale), by exact overlap with the device's gaps
(``program_spans.py``)."""

from mvsbench.program_spans import stage_idle_ms


def read(rec):
    return stage_idle_ms(rec, "runner.priors_idle_ms_per_pass")
