"""BERT-base encoder, the bin-packed inference workload (port of the JAX
package's ``models/bert.py``).

Post-LN encoder: non-causal ``dense_attention`` with no padding mask,
learned position embeddings, a tanh-approximated GELU MLP and LayerNorm
with JAX's rounding (``layer_norm``). ``Bert`` holds the weights in JAX's
``[K, N]`` orientation, one ``BertBlock`` per layer (the JAX package's
stacked ``blocks``); ``encode`` returns the final hidden states,
``classify`` the [CLS]-pooled logits. ``main()`` is the pod's entry point
(``python -m k8s_gpu_scheduler_tpu_torch.models.bert``): it reports the
qps achieved against the SLO the scheduler scored it by. No Pallas kernel
sits behind the JAX model, so the port is plain PyTorch.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.attention import dense_attention


@dataclass(frozen=True)
class BertConfig:
    vocab: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq: int = 512
    n_classes: int = 2
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny() -> "BertConfig":
        return BertConfig(vocab=128, d_model=32, n_layers=2, n_heads=4,
                          d_ff=64, max_seq=64)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """Normalise in f32, cast to x's dtype, then scale and shift in that
    dtype (``F.layer_norm`` applies the affine in f32 and rounds once,
    which gives other bf16 bits)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def _full(cfg: BertConfig, device, value: float, *shape) -> nn.Parameter:
    """A frozen parameter of ``shape`` filled with ``value``."""
    return nn.Parameter(torch.full(shape, value, dtype=cfg.dtype,
                                   device=device), requires_grad=False)


class BertBlock(nn.Module):
    """One encoder layer: ``wqkv [D, 3·H·hd]`` (q, k, v in thirds),
    ``wo``, ``w1``, ``w2`` and the two LayerNorms' scale and bias."""

    def __init__(self, cfg: BertConfig, device: torch.device) -> None:
        super().__init__()
        D, F_ = cfg.d_model, cfg.d_ff
        self.wqkv = _full(cfg, device, 0.0, D, 3 * D)
        self.wo = _full(cfg, device, 0.0, D, D)
        self.ln1_s, self.ln1_b = (_full(cfg, device, 1.0, D),
                                  _full(cfg, device, 0.0, D))
        self.w1 = _full(cfg, device, 0.0, D, F_)
        self.w2 = _full(cfg, device, 0.0, F_, D)
        self.ln2_s, self.ln2_b = (_full(cfg, device, 1.0, D),
                                  _full(cfg, device, 0.0, D))


class Bert(nn.Module):
    """The encoder's weights (``tok_embed``, ``pos_embed``, ``blocks``,
    ``final_ln_s``/``final_ln_b``, ``cls [D, n_classes]``), created frozen:
    the workload only serves."""

    def __init__(self, cfg: BertConfig, device="cuda") -> None:
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        D = cfg.d_model
        self.tok_embed = _full(cfg, device, 0.0, cfg.vocab, D)
        self.pos_embed = _full(cfg, device, 0.0, cfg.max_seq, D)
        self.blocks = nn.ModuleList(BertBlock(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_ln_s, self.final_ln_b = (_full(cfg, device, 1.0, D),
                                            _full(cfg, device, 0.0, D))
        self.cls = _full(cfg, device, 0.0, D, cfg.n_classes)

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device


def init_params(cfg: BertConfig, generator: torch.Generator,
                device="cuda") -> Bert:
    """Random weights from ``generator`` alone: normal(0, 0.02) matrices
    and embeddings (drawn in f32 on the CPU, cast to the model dtype),
    unit LayerNorm scales and zero biases."""
    model = Bert(cfg, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "ln" in name.rsplit(".", 1)[-1]:         # LayerNorms
                continue
            p.copy_((torch.randn(p.shape, generator=generator,
                                 dtype=torch.float32) * 0.02).to(p.dtype))
    return model


def encode(model: Bert, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] → hidden [B, T, D] (bidirectional attention)."""
    cfg = model.cfg
    B, T = tokens.shape
    x = (model.tok_embed[tokens] + model.pos_embed[:T]).to(cfg.dtype)
    shape = (B, T, cfg.n_heads, cfg.head_dim)
    for blk in model.blocks:
        q, k, v = (x @ blk.wqkv).chunk(3, dim=-1)
        attn = dense_attention(q.reshape(shape), k.reshape(shape),
                               v.reshape(shape), causal=False)
        x = layer_norm(x + attn.reshape(B, T, -1) @ blk.wo,
                       blk.ln1_s, blk.ln1_b)
        h = F.gelu(x @ blk.w1, approximate="tanh") @ blk.w2
        x = layer_norm(x + h, blk.ln2_s, blk.ln2_b)
    return layer_norm(x, model.final_ln_s, model.final_ln_b)


def classify(model: Bert, tokens: torch.Tensor) -> torch.Tensor:
    """[CLS]-pooled logits [B, n_classes] in f32: the serving surface."""
    return (encode(model, tokens)[:, 0] @ model.cls).float()


def main(*, device="cuda") -> None:
    """The pod's entry point: BERT-base at B 32, T 128 under the
    scheduler-injected limits, one synchronised ``classify`` a second,
    each printing ``bert-base qps=… slo=… chips=…`` and publishing the qps
    to the recommender. Runs until the pod is stopped."""
    import os
    import time

    from ..recommender.collector import make_workload_publisher
    from ..utils.enforcement import apply_env_limits

    dev = resolve_device(device)
    throttle = apply_env_limits(device=dev)    # memory cap + duty pacing
    cfg = BertConfig.base()
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    B, T = 32, 128
    tokens = torch.randint(0, cfg.vocab, (B, T),
                           generator=torch.Generator().manual_seed(1)).to(dev)

    def infer():
        classify(model, tokens)
        if dev.type == "cuda":
            # The pod's timing barrier, as the JAX pod's block_until_ready:
            # graftcheck: ignore[host-sync]
            torch.cuda.synchronize(dev)

    infer()                                    # warm-up
    slo = float(os.environ.get("SLO", "0") or 0)
    publish = make_workload_publisher()
    while True:
        t0 = time.perf_counter()
        infer()                 # the synchronised call is the measurement
        step_dt = time.perf_counter() - t0
        qps = B / step_dt
        if throttle is not None:
            throttle.pace(step_dt)
        print(f"bert-base qps={qps:.1f} slo={slo} "
              f"chips={os.environ.get('TPU_VISIBLE_CHIPS', '?')}", flush=True)
        if publish is not None:
            publish(qps)        # the feedback loop (recommender/collector.py)
        time.sleep(1)


if __name__ == "__main__":
    main()
