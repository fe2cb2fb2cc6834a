"""The 85th percentile (nearest rank) of the host walls of every pass of
the window, each from the call of ``run_view_pass`` to its return, which
ends in the runner's host copies of the view's state.  The 85th leaves at
least ten passes beyond it from 67 passes in the window on."""

from mvsbench.measure import percentile


def read(window):
    return percentile(window.pass_s, 85)
