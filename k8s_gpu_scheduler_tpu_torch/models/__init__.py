"""Model layer of the port: the Llama decoder and the paged,
prefix-cached serving engine."""
from .llama import Llama, LlamaConfig, forward, forward_with_aux, init_params
from .serving import ContinuousBatcher

__all__ = ["ContinuousBatcher", "Llama", "LlamaConfig", "forward",
           "forward_with_aux", "init_params"]
