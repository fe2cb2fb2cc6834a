"""Device operations (kernels, copies and sets) a traced pass, from the
profiler."""


def read(rec):
    return len(rec.device) / rec.n_passes
