"""K5-K7 (flash attention): least time over device time."""
from portbench.readings import flash_roofline as read  # noqa: F401
