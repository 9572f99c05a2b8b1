"""Core ops of the port: transformer primitives, weight-only int8, dense
attention, the mixture-of-experts FFN, the decode-time attention entry points (paged K1-K3, contiguous
flash-decode K4) and flash attention for training (K5-K7), whose CUDA
kernels live in ``csrc/`` (built at first use by ``_build``)."""
from .attention import dense_attention
from .decode_attention import (
    DEFAULT_PAGE_SIZE, contiguous_as_paged, decode_plan,
    dense_decode_reference, dense_prefill_reference, dense_verify_reference,
    flash_decode_attention, flash_decode_plan, flash_decode_reference,
    gather_paged_kv, paged_decode_attention, paged_decode_reference,
    paged_plan, paged_prefill_attention, paged_verify_attention,
    paged_verify_reference, verify_plan,
)
from .flash_attention import (
    flash_attention, flash_attention_diff, flash_backward,
    flash_backward_reference, flash_forward, flash_forward_reference,
)
from .layers import apply_rope, rms_norm, rope_freqs, swiglu
from .moe import (
    expert_capacity, load_balancing_loss, moe_ffn, moe_ffn_dropless,
)
from .quant import (
    Int8Weight, dequantize_weight, qdot, qeinsum, quantize_llama_params,
    quantize_weight,
)

__all__ = [
    "DEFAULT_PAGE_SIZE", "Int8Weight", "apply_rope", "contiguous_as_paged",
    "decode_plan", "dense_attention", "dense_decode_reference", "dense_prefill_reference",
    "dense_verify_reference", "dequantize_weight", "expert_capacity",
    "flash_attention",
    "flash_attention_diff", "flash_backward", "flash_backward_reference",
    "flash_decode_attention", "flash_decode_plan", "flash_decode_reference",
    "flash_forward", "flash_forward_reference", "gather_paged_kv",
    "load_balancing_loss", "moe_ffn", "moe_ffn_dropless",
    "paged_decode_attention", "paged_decode_reference", "paged_plan",
    "paged_prefill_attention", "paged_verify_attention",
    "paged_verify_reference", "qdot", "qeinsum", "quantize_llama_params",
    "quantize_weight", "rms_norm", "rope_freqs", "swiglu", "verify_plan",
]
