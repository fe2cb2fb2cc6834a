"""The scene runner's own host time a pass: the host wall of each traced
``run_view_pass`` less that of the ``run_pass`` call inside it (which ends
in a synchronize), summed over the traced passes, over their count."""


def read(rec):
    if not rec.run_pass_s:
        return None
    return 1e3 * (sum(rec.view_pass_s) - sum(rec.run_pass_s)) / rec.n_passes
