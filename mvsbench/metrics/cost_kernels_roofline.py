"""The cost kernels' share of their roofline, in %: the sum over the calls
of their entry points (``fused_ncc_costs``, ``sweep_weighted_ncc``,
``geom_cost``, ``anchor_slot_costs``, ``warp_ncc``) of each call's bound
(the larger of its operations over 67 TFLOP/s and its bytes over
3.35 TB/s, counted from its arguments, ``measure.py``) over the sum of the
device time of everything launched inside those calls."""


def read(rec):
    dev = sum(c.device_s for c in rec.calls)
    if not rec.calls or dev <= 0:
        return None
    return 100.0 * sum(c.bound_s for c in rec.calls) / dev
