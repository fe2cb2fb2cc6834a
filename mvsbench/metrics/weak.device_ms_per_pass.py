"""Device ms a traced pass of everything launched inside ``find_anchors``
and ``ransac_fit_plane``; nothing where the passes run neither (no weak
machinery)."""

SPANS = ("mvsbench:weak/find_anchors", "mvsbench:weak/ransac_fit_plane")


def read(rec):
    ns = [op.end_ns - op.start_ns for op in rec.device
          if any(s in op.spans for s in SPANS)]
    if not ns:
        return None
    return sum(ns) * 1e-6 / rec.n_passes
