"""mvsbench: the benchmark of ``dvpmvs_torch``, the PyTorch and CUDA port of
DVP-MVS.  ``python3 -m mvsbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints its result as the last line
of standard output (``run.py``; README.md)."""
