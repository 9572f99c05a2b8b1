"""Process start to the window's start."""
from portbench.readings import setup_s as read  # noqa: F401
