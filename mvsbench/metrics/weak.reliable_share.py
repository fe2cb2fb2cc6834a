"""The share of the weak pixels entering the anchor search whose anchors
are reliable (kept weak, not demoted): the program's counters
``weak.reliable`` over ``weak.pixels`` (``program_spans.py``)."""

from mvsbench.program_spans import share


def read(rec):
    return share(rec, "weak.reliable", "weak.pixels")
