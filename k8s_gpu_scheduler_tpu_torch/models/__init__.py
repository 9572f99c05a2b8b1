"""Model layer of the port: the Llama decoder (dense or mixture-of-experts)
with its training step, its pipeline schedules (GPipe and 1F1B over a
``pp`` axis), the single-sequence decode functions, the serving engine
over a paged or a contiguous KV cache, and the BERT-base and ResNet-50
pod workloads."""
from .bert import BertConfig
from .llama import (
    Llama, LlamaConfig, forward, forward_with_aux, init_params, loss_fn,
    make_optimizer, make_train_step,
)
from .serving import (
    ContinuousBatcher, generate, generate_speculative, make_server_step,
    make_speculative_server_step,
)
from .resnet import ResNetConfig
from .pipeline import make_pp_train_step, pp_loss_fn

__all__ = ["BertConfig", "ContinuousBatcher", "Llama", "LlamaConfig",
           "ResNetConfig", "forward",
           "forward_with_aux", "generate", "generate_speculative",
           "init_params", "loss_fn", "make_optimizer", "make_pp_train_step",
           "make_server_step", "make_speculative_server_step",
           "make_train_step", "pp_loss_fn"]
