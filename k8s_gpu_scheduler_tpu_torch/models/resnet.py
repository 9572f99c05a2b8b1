"""ResNet-50, the single-card training workload (port of the JAX
package's ``models/resnet.py``).

Bottleneck ResNet whose batch norm normalises with the batch's own
statistics (f32, biased variance) and keeps no running averages, as the
JAX model does. The JAX model is NHWC with HWIO weights; here images come
in NHWC and are viewed as NCHW in the channels-last memory format, and
conv weights are OIHW (``bridge.resnet_params_from_numpy`` converts JAX's
once). ``padding="SAME"`` pads asymmetrically at stride 2 (more at the
end), which PyTorch's integer padding cannot say, so ``_conv`` and the max
pool pad explicitly where the two sides differ. ``main()`` is the pod's
entry point (``python -m k8s_gpu_scheduler_tpu_torch.models.resnet``). No
Pallas kernel sits behind the JAX model: convolutions and elementwise code
are plain PyTorch (cuDNN on the card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple = (3, 4, 6, 3)  # ResNet-50
    width: int = 64
    n_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def resnet50() -> "ResNetConfig":
        return ResNetConfig()

    @staticmethod
    def tiny() -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(1, 1), width=8, n_classes=10)


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: (before, after)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, k: int, stride: int):
    (top, bottom), (left, right) = (_same_pad(x.shape[2], k, stride),
                                    _same_pad(x.shape[3], k, stride))
    return top, bottom, left, right


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x [B, C, H, W] conv w [O, C, k, k], "SAME" padding."""
    top, bottom, left, right = _pads(x, w.shape[-1], stride)
    if (top, left) == (bottom, right):
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool at stride 2, "SAME" padding with -inf."""
    top, bottom, left, right = _pads(x, 3, 2)
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def _bn(x: torch.Tensor, bn: "BatchNorm", eps: float = 1e-5) -> torch.Tensor:
    """Batch statistics in f32 (biased variance), normalised, cast to x's
    dtype, then scaled and shifted in that dtype."""
    x32 = x.float()
    mu = x32.mean((0, 2, 3), keepdim=True)
    var = ((x32 - mu) ** 2).mean((0, 2, 3), keepdim=True)
    xn = ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return xn * bn.scale[:, None, None] + bn.bias[:, None, None]


class BatchNorm(nn.Module):
    """A batch norm's learned ``scale`` and ``bias`` [C]; no running
    statistics."""

    def __init__(self, c: int, cfg: ResNetConfig, device) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, dtype=cfg.dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(c, dtype=cfg.dtype,
                                             device=device))


def _conv_w(cin: int, cout: int, k: int, cfg: ResNetConfig,
            device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(cout, cin, k, k, dtype=cfg.dtype,
                                    device=device).to(
        memory_format=torch.channels_last))


class Bottleneck(nn.Module):
    """1x1 → 3x3 (stride 2 opening stages 1 on) → 1x1 (x4 channels), each
    with a batch norm; a stage's first block projects its input (``proj``,
    ``bproj``), the others have none."""

    def __init__(self, cin: int, cmid: int, project: bool,
                 cfg: ResNetConfig, device) -> None:
        super().__init__()
        cout = 4 * cmid
        self.c1 = _conv_w(cin, cmid, 1, cfg, device)
        self.b1 = BatchNorm(cmid, cfg, device)
        self.c2 = _conv_w(cmid, cmid, 3, cfg, device)
        self.b2 = BatchNorm(cmid, cfg, device)
        self.c3 = _conv_w(cmid, cout, 1, cfg, device)
        self.b3 = BatchNorm(cout, cfg, device)
        self.proj = _conv_w(cin, cout, 1, cfg, device) if project else None
        self.bproj = BatchNorm(cout, cfg, device) if project else None


class ResNet(nn.Module):
    """The network's weights: ``stem`` (7x7/2 conv and its batch norm),
    ``stages`` of ``Bottleneck`` blocks and ``head [C, n_classes]``."""

    def __init__(self, cfg: ResNetConfig, device="cuda") -> None:
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.stem = _conv_w(3, cfg.width, 7, cfg, device)
        self.stem_bn = BatchNorm(cfg.width, cfg, device)
        self.stages = nn.ModuleList()
        cin = cfg.width
        for s, n_blocks in enumerate(cfg.stage_sizes):
            cmid = cfg.width * 2 ** s
            self.stages.append(nn.ModuleList(
                Bottleneck(cin if b == 0 else 4 * cmid, cmid, b == 0, cfg,
                           device) for b in range(n_blocks)))
            cin = 4 * cmid
        self.head = nn.Parameter(torch.zeros(cin, cfg.n_classes,
                                             dtype=cfg.dtype, device=device))

    @property
    def device(self) -> torch.device:
        return self.head.device


def init_params(cfg: ResNetConfig, generator: torch.Generator,
                device="cuda") -> ResNet:
    """Random weights from ``generator`` alone (drawn in f32 on the CPU,
    cast to the model dtype): He-normal convs (std sqrt(2 / fan_in)), a
    normal(0, 0.01) head, unit batch-norm scales and zero biases."""
    model = ResNet(cfg, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 4:
                std = (2.0 / p[0].numel()) ** 0.5
            elif name == "head":
                std = 0.01
            else:
                continue
            p.copy_((torch.randn(p.shape, generator=generator,
                                 dtype=torch.float32) * std).to(p.dtype))
    return model


def forward(model: ResNet, images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] → logits [B, n_classes] f32."""
    cfg = model.cfg
    x = images.to(cfg.dtype).permute(0, 3, 1, 2)      # channels-last NCHW
    x = F.relu(_bn(_conv(x, model.stem, stride=2), model.stem_bn))
    x = _max_pool(x)
    for s, blocks in enumerate(model.stages):
        for b, blk in enumerate(blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            h = F.relu(_bn(_conv(x, blk.c1), blk.b1))
            h = F.relu(_bn(_conv(h, blk.c2, stride=stride), blk.b2))
            h = _bn(_conv(h, blk.c3), blk.b3)
            if blk.proj is not None:
                x = _bn(_conv(x, blk.proj, stride=stride), blk.bproj)
            x = F.relu(x + h)
    return (x.mean(dim=(2, 3)) @ model.head).float()


def loss_fn(model: ResNet, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean cross entropy of ``batch["labels"]`` [B] under the logits of
    ``batch["images"]``."""
    logp = torch.log_softmax(forward(model, batch["images"]), dim=-1)
    return -logp.gather(1, batch["labels"][:, None].long()).mean()


def make_train_step(cfg: ResNetConfig, optimizer: torch.optim.Optimizer):
    """``step(model, batch) -> loss``: forward, backward and one update
    in place (the JAX step returned new params and optimizer state). The
    loss comes back as a detached f32 scalar, unsynchronised."""

    def step(model: ResNet, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if model.cfg != cfg:
            raise ValueError("the model's config differs from the step's")
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_optimizer(model: ResNet) -> torch.optim.SGD:
    """``optax.sgd(0.1, momentum=0.9)``: no dampening, no Nesterov, and
    the first momentum buffer is the gradient itself, as optax's trace
    starts from zeros; the buffer and the update stay in the parameters'
    dtype."""
    return torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)


def main(*, device="cuda") -> None:
    """The pod's entry point: ResNet-50 training at B 64 on one fixed
    batch of 224x224 images under the scheduler-injected limits, printing
    ``resnet50 img/s=… loss=… slo=… chips=…`` a step and publishing the
    img/s to the recommender about once a second. Runs until the pod is
    stopped."""
    import os
    import time

    from ..recommender.collector import make_workload_publisher
    from ..utils.enforcement import apply_env_limits

    dev = resolve_device(device)
    throttle = apply_env_limits(device=dev)    # memory cap + duty pacing
    cfg = ResNetConfig.resnet50()
    model = init_params(cfg, torch.Generator().manual_seed(0), dev)
    B = 64
    batch = {
        "images": torch.randn(B, 224, 224, 3, generator=torch.Generator()
                              .manual_seed(1)).to(dev),
        "labels": torch.randint(0, cfg.n_classes, (B,),
                                generator=torch.Generator().manual_seed(2)
                                ).to(dev),
    }
    step = make_train_step(cfg, make_optimizer(model))
    float(step(model, batch))                  # warm-up
    slo = float(os.environ.get("SLO", "0") or 0)
    publish = make_workload_publisher()
    last_pub = 0.0
    while True:
        t0 = time.perf_counter()
        loss = float(step(model, batch))       # the step's one host read
        step_dt = time.perf_counter() - t0
        ips = B / step_dt
        if throttle is not None:
            throttle.pace(step_dt)
        print(f"resnet50 img/s={ips:.1f} loss={loss:.3f} slo={slo} "
              f"chips={os.environ.get('TPU_VISIBLE_CHIPS', '?')}", flush=True)
        # Published about once a second on the monotonic clock, so a fast
        # step cannot hammer the registry.
        if publish is not None and time.monotonic() - last_pub >= 1.0:
            publish(ips)
            last_pub = time.monotonic()


if __name__ == "__main__":
    main()
