"""Training tokens per second over the window."""
from portbench.readings import train_tok_s as read  # noqa: F401
