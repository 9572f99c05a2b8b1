"""Model layer of the port: the Llama decoder with its training step, and
the paged, prefix-cached serving engine."""
from .llama import (
    Llama, LlamaConfig, forward, forward_with_aux, init_params, loss_fn,
    make_optimizer, make_train_step,
)
from .serving import ContinuousBatcher

__all__ = ["ContinuousBatcher", "Llama", "LlamaConfig", "forward",
           "forward_with_aux", "init_params", "loss_fn", "make_optimizer",
           "make_train_step"]
