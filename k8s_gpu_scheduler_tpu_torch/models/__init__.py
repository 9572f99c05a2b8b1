"""Model layer of the port: the Llama decoder with its training step, the
single-sequence decode functions, and the serving engine over a paged or a
contiguous KV cache."""
from .llama import (
    Llama, LlamaConfig, forward, forward_with_aux, init_params, loss_fn,
    make_optimizer, make_train_step,
)
from .serving import (
    ContinuousBatcher, generate, generate_speculative, make_server_step,
    make_speculative_server_step,
)

__all__ = ["ContinuousBatcher", "Llama", "LlamaConfig", "forward",
           "forward_with_aux", "generate", "generate_speculative",
           "init_params", "loss_fn", "make_optimizer", "make_server_step",
           "make_speculative_server_step", "make_train_step"]
