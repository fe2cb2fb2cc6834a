"""Device ms a traced pass of the operations that are not the program's own
CUDA kernels (the ``__global__`` functions of its ``csrc/``): PyTorch's
kernels, copies and sets, launched by the glue around the cost kernels."""

from mvsbench.trace import program_kernel_pattern


def read(rec):
    own = program_kernel_pattern(rec.program_kernels)
    ns = sum(op.end_ns - op.start_ns for op in rec.device
             if own is None or not own.search(op.name))
    return ns * 1e-6 / rec.n_passes
