"""``device_idle_pct.graph``: the device's idle share while the window
ran, one iteration of the fused program the unit of work
(:func:`portbench.trace.idle_pct`)."""
from portbench.trace import idle_pct as read  # noqa: F401
