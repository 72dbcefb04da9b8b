import time

_T0 = time.monotonic()

from portbench.run import main  # noqa: E402

raise SystemExit(main(t0=_T0))
