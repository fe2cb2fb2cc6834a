"""Device idle ms a traced pass that no stage metric takes: the idle time
of the traced run's window (``device.idle_share`` x window) less the
stages' (``program_spans.py``): the self time of ``runner/view_pass``,
``engine/pass`` and ``runner/finish``, and the harness's own."""

from mvsbench.program_spans import unspanned_idle_ms


def read(rec):
    return unspanned_idle_ms(rec)
