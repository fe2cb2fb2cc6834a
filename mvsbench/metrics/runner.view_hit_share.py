"""The share of the scaled views a traced pass asks the scene runner for
that its cache serves: the program's counters ``runner.view_hits`` over
``runner.views`` (``program_spans.py``)."""

from mvsbench.program_spans import share


def read(rec):
    return share(rec, "runner.view_hits", "runner.views")
