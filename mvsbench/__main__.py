"""``python3 -m mvsbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell (``run.py``)."""

import time

STARTED = time.perf_counter()

if __name__ == "__main__":
    import sys

    from .run import main

    sys.exit(main(started=STARTED))
