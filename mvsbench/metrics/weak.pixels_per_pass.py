"""Weak pixels entering the anchor search a traced pass: the program's
counter ``weak.pixels`` (``program_spans.py``); nothing where no pass runs
the weak machinery."""

from mvsbench.program_spans import count_per_pass


def read(rec):
    return count_per_pass(rec, "weak.pixels")
