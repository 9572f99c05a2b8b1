"""The training loop: the port's ``make_train_step`` with AdamW, fed a
fresh seeded batch every step. Set-up drives the same step object through
its first three steps and reads what the comparison needs (each step's
loss, each leaf's first gradient from the optimizer's state, each leaf's
change after the three); the window then times further steps, each ended
by a synchronise. The float32 reference follows the same three steps once
the program's state is freed."""
from __future__ import annotations

import math
import time
from types import SimpleNamespace
from typing import Dict, List, Tuple

import torch

from ..check import passed, train_gaps, verdict
from ..devtrace import Profiler
from ..reference.train import follow
from ..traffic import train_batch
from ..weights import draw, draw_leaf, port_config, port_model

FIRST_STEPS = 3
LR = 3e-4


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


class Trainer:
    def __init__(self, cfg: Dict, pcfg, mix: Dict, seed: int, device):
        from k8s_gpu_scheduler_tpu_torch.models.llama import (
            make_optimizer, make_train_step)

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.weights = draw(cfg, seed, device)
        self.model = port_model(pcfg, self.weights)
        self.opt = make_optimizer(self.model, LR)
        self.step_fn = make_train_step(pcfg, None, self.opt)
        self.k = 0
        self.losses: List[torch.Tensor] = []

    def batch(self, k: int):
        return train_batch(self.mix, self.seed, k, self.cfg["vocab_size"],
                           self.device)

    def step(self) -> torch.Tensor:
        loss = self.step_fn(self.model, self.batch(self.k))
        self.k += 1
        self.losses.append(loss)
        return loss

    def first_steps(self) -> Dict[str, object]:
        """Steps 1-3 and the program's readings of them."""
        names = [n for n, _ in self.model.named_parameters()]
        losses = [float(self.step())]
        b1 = self.opt.defaults["betas"][0]
        # m after one step is (1 - b1) g; a leaf with no state was not
        # stepped and reads NaN, which no limit passes
        grad1 = {n: float(self.opt.state[p]["exp_avg"].float().norm())
                 / (1 - b1) if "exp_avg" in self.opt.state.get(p, {})
                 else float("nan")
                 for n, p in self.model.named_parameters()}
        for _ in range(FIRST_STEPS - 1):
            losses.append(float(self.step()))
        with torch.no_grad():
            change = {n: float((p.float() - draw_leaf(
                self.cfg, self.seed, n, self.device).float()).norm())
                for n, p in self.model.named_parameters()}
        self.names = names
        return {"losses": losses, "grad1": grad1, "change": change}

    def window(self, seconds: float, profiler=None,
               trace_steps: Tuple[int, int] = (0, 0)
               ) -> List[Tuple[float, float]]:
        """Steps until ``seconds`` have passed, each ended by a
        synchronise: their (start, end) host times. Steps
        ``trace_steps[0]`` up to ``trace_steps[1]`` of the window run
        under ``profiler`` (the window runs on until they are done)."""
        out: List[Tuple[float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        tracing = False
        _sync(self.device)
        start = time.monotonic()
        while (not out or out[-1][1] - start < seconds
               or (profiler is not None and len(out) < trace_steps[1])):
            if profiler is not None and len(out) == trace_steps[0]:
                profiler.start()
                tracing = True
            t0 = time.monotonic()
            self.step()
            t_enq = time.monotonic()
            _sync(self.device)
            t1 = time.monotonic()
            out.append((t0, t1))
            self.host += [("train.step_call", t0, t_enq),
                          ("train.synchronize", t_enq, t1)]
            if tracing and len(out) == trace_steps[1]:
                profiler.stop()
                tracing = False
        return out

    def free(self) -> None:
        del self.step_fn, self.opt, self.model, self.weights
        self.losses = [float(x) for x in self.losses]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _reference(cell, seed: int, names: List[str], device, **kw) -> Dict:
    """The float32 reference's three steps from the same initial weights
    and batches (``kw``: ``lowp``, ``rows``)."""
    cfg = cell.config
    batches = [train_batch(cell.mix, seed, k, cfg["vocab_size"], device)
               for k in range(FIRST_STEPS)]
    return follow(lambda n: draw_leaf(cfg, seed, n, device), names, cfg,
                  batches, **kw)


def run(cell, seed: int, seconds: float, trace: bool, device) -> Dict:
    cfg, wl = cell.config, cell.workload
    pcfg = port_config(cfg, attn_impl=wl.get("attn_impl", "flash"),
                       remat=bool(wl.get("remat", True)))
    tr = Trainer(cfg, pcfg, cell.mix, seed, device)
    prog = tr.first_steps()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prof = Profiler() if trace else None
    if trace:
        Profiler.warm()
    w0 = time.monotonic()
    t0, n = wl.get("trace_steps", [2, 2])
    steps = tr.window(seconds, prof, (t0, t0 + n))
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    losses = [float(x) for x in tr.losses]
    failed = sum(1 for x in losses[len(losses) - len(steps):]
                 if not math.isfinite(x))
    names, host = list(tr.names), tr.host
    tr.free()
    del tr
    want = _reference(cell, seed, names, device)
    readings = train_gaps(prog, want)
    checks = verdict(readings, wl["limits"])
    readings = {k: v for k, v in readings.items() if k not in checks}
    ctx = SimpleNamespace(
        cfg=cfg, w0=w0, steps=steps, host=host, spans=[],
        batch=int(cell.mix["batch"]), seq=int(cell.mix["seq"]),
        trace=prof.trace if prof is not None else None, traced_steps=n)
    return dict(ctx=ctx, attempted=len(steps), failed=failed, peak=peak,
                checks=checks, readings=readings,
                correct=passed(checks) and failed == 0,
                prog=prog, want=want, names=names)


def control(cell, seed: int, device, seconds: float = 4.0) -> Dict:
    """The program's first three steps (a short run of the cell), the
    float8 reference's (the control) and the reference's on half of each
    batch (the mean over the rest), each compared with the float32
    reference as ``correct`` compares the program. A state left unchanged
    reads 1 by the change's measure and needs no run."""
    out = run(cell, seed, seconds, False, device)
    names, want = out["names"], out["want"]
    low = _reference(cell, seed, names, device, lowp="fp8")
    half = _reference(cell, seed, names, device,
                      rows=slice(0, int(cell.mix["batch"]) // 2))
    return {"seed": seed, "correct": out["correct"],
            "program": train_gaps(out["prog"], want),
            "control_fp8": train_gaps(low, want),
            "half_batch": train_gaps(half, want)}
