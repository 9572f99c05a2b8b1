"""The training steps' model operations over their seconds at the bf16 peak."""
from portbench.readings import train_mfu as read  # noqa: F401
