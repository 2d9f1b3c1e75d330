"""`python3 -m port_bench`: one run of one benchmark cell (see run.py)."""

import time

_T_START = time.perf_counter()   # set-up is timed from here

if __name__ == "__main__":
    import sys

    from port_bench.run import main
    sys.exit(main(t_start=_T_START))
