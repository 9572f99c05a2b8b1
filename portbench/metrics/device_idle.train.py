"""Share of the traced window with no device operation running."""
from portbench.readings import device_idle as read  # noqa: F401
