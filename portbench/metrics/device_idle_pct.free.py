"""``device_idle_pct.free``: the device's idle share while the window
ran, one ``run_optimizer`` call of the user's loop the unit of work
(:func:`portbench.trace.idle_pct`)."""
from portbench.trace import idle_pct as read  # noqa: F401
