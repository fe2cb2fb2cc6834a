"""1 - the union of the device's operation intervals over the traced
passes' wall, from the start of the first to the end of the last."""


def read(rec):
    return 1.0 - rec.busy_s / rec.window_s
