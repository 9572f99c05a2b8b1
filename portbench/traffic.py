"""The one traffic generator. A mix is a data file, ``traffic/<mix>.json``,
whose ``kind`` names the loop that runs it (``loops/<kind>.py``); this
module turns it and a seed into that loop's inputs.

Train mixes (``kind`` "train") give ``batch`` and ``seq``: every step
takes a fresh batch of random token ids, drawn on the card from (seed,
step), so every seed gives the same sizes and every row differs.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def train_batch(mix: Dict, seed: int, step: int, vocab: int, device):
    """Step ``step``'s batch {tokens, targets} [B, T] of random token ids,
    drawn on ``device`` from (seed, step): every row differs."""
    import torch

    B, T = int(mix["batch"]), int(mix["seq"])
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix_seed(seed, 1000 + step))
    seq = torch.randint(0, vocab, (B, T + 1), generator=gen, device=device)
    return {"tokens": seq[:, :-1].contiguous(),
            "targets": seq[:, 1:].contiguous()}


def _mix_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed from (seed, stream)."""
    return int(np.random.SeedSequence([int(seed) & (2 ** 64 - 1),
                                       stream]).generate_state(
        1, np.uint64)[0]) & (2 ** 63 - 1)
