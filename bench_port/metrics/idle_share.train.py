"""Device: the share of the profiled window in which no operation ran on
the card (the window less the union of the operations' intervals)."""
from bench_port.core.readers import idle_share as read  # noqa: F401
