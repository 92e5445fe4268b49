import time

T_START = time.monotonic()   # set-up is timed from here, imports included

from h100_bench.run import main  # noqa: E402

raise SystemExit(main(t_start=T_START))
