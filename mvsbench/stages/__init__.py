"""The stages a traffic mix can drive, one module each, found by name
(``cells.stage_module``): ``traffic/<name>.json`` names its ``stage``, and
``view_pass`` where it names none.

A stage module supplies what differs between stages; ``run.py`` keeps the
rest (the clock, the window loop, the traced window under the profiler,
the kernels' build, peak bytes, the import guard, the draw of the checked
passes and the result line):

  Plan(cell)              the cell's schedule; ``trace_passes`` is how
                          many window passes a traced run profiles
  make_inputs(plan, cfg, seed, card)
                          the inputs from the seed (set-up's first step),
                          which the check hands to the reference too
  set_up(plan, cfg, inputs, seed, card)
                          the program's objects over the inputs, with one
                          warm pass of each kind; the object it returns has
                          ``window_pass(k)`` -> ``Pass``, ``kept`` (what
                          the check needs once the program is freed) and
                          ``facts`` (further keys of the result line)
  OUTER_SPAN              the benchmark's span around a traced pass
  PROGRAM_SPAN            the program's span that bounds a pass
                          (``program_spans.py``)
  install_spans(tracer)   the traced run's wrappers: ``tracer.install``
                          with the timed, plain and kernel spans
  WORK                    (work, deferred_work) for the kernel spans'
                          operations and bytes (``trace.Tracer``);
                          deferred_work may be None where work defers
                          nothing
  check(plan, cfg, inputs, kept, picked, seed, card)
                          the picked passes made again by the stage's
                          plain reference and compared: ({name: {"value",
                          "limit"}}, count of passes not correct)
  control(torch, cell, seed, card)
                          optional: the program's and the control's
                          numbers on one seed (``control.py``)
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass
class Pass:
    """The window's k-th pass: its kind (the key the checked passes are
    drawn by), the call the window times, and ``finish``, which restores
    the state the pass changed and returns its entry of the window's
    passes (kind first, the program's output last)."""

    kind: object
    call: Callable[[], None]
    finish: Callable[[], tuple]
