"""The training step in plain float32 PyTorch: the causal-LM cross entropy
of the reference decoder (the mean over every token of logsumexp(logits) -
logits[target]) and its gradient; then AdamW with decoupled weight decay
(betas 0.9 / 0.999, eps 1e-8, weight decay 1e-4).

The gradient is summed over rows, one at a time, and each decoder block is
recomputed in the backward (``torch.utils.checkpoint``), so that the
float32 weights, gradients and AdamW moments fit on one card beside a
block's activations."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .model import block, mm, rms_norm

Weights = Dict[str, torch.Tensor]


def loss_and_grads(params: Weights, cfg: Dict, batch: Dict[str, torch.Tensor],
                   lowp: Optional[str] = None, rows: slice = slice(None)
                   ) -> float:
    """The batch's mean loss; each leaf's ``.grad`` holds its gradient.
    ``params`` are float32 leaves that require grad. ``rows`` keeps a
    part of the batch (the mean is then over that part)."""
    tokens, targets = batch["tokens"][rows], batch["targets"][rows]
    B, T = tokens.shape
    L = cfg["num_hidden_layers"]
    layers = [{k[len(f"blocks.{i}."):]: v for k, v in params.items()
               if k.startswith(f"blocks.{i}.")} for i in range(L)]
    pos = torch.arange(T, device=tokens.device)
    for p in params.values():
        p.grad = None
    total = 0.0
    for r in range(B):
        x = params["embed"][tokens[r]]
        for w in layers:
            x = torch.utils.checkpoint.checkpoint(
                block, x, w, cfg, pos, lowp, use_reentrant=False)
        h = rms_norm(x, params["final_norm"], cfg["rms_norm_eps"])
        lg = mm(h, params["lm_head"], lowp)
        loss = F.cross_entropy(lg, targets[r].long(),
                               reduction="sum") / (B * T)
        loss.backward()
        total += float(loss.detach())
    return total


class AdamW:
    """AdamW over a dict of float32 leaves, optax's ``adamw`` defaults
    but for the learning rate: m, v moments, bias correction, decay
    applied to the weights before the step."""

    def __init__(self, params: Weights, lr: float = 3e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, wd: float = 1e-4):
        self.params, self.lr, self.b1, self.b2 = params, lr, b1, b2
        self.eps, self.wd, self.t = eps, wd, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            m, v, g = self.m[k], self.v[k], p.grad
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (m / c1).div_((v / c2).sqrt_().add_(self.eps))
            p.mul_(1 - self.lr * self.wd)
            p.add_(u, alpha=-self.lr)


def follow(initial: Callable[[str], torch.Tensor], names: List[str],
           cfg: Dict, batches: List[Dict[str, torch.Tensor]],
           lowp: Optional[str] = None, rows: slice = slice(None)
           ) -> Dict[str, object]:
    """Train from the initial weights (``initial(name)``, each leaf as
    drawn) through ``batches``: each step's loss, each leaf's first
    gradient norm and its change norm after the last step."""
    params = {n: initial(n).float().requires_grad_() for n in names}
    opt = AdamW(params)
    losses, grad1 = [], {}
    for i, b in enumerate(batches):
        losses.append(loss_and_grads(params, cfg, b, lowp, rows=rows))
        if i == 0:
            grad1 = {n: float(p.grad.norm()) for n, p in params.items()}
        opt.step()
        for p in params.values():
            p.grad = None
    del opt
    change = {n: float((p.detach() - initial(n).float()).norm())
              for n, p in params.items()}
    return {"losses": losses, "grad1": grad1, "change": change}
