"""The traffic generator: deterministic per seed, a fresh batch every
step, every row different."""
from __future__ import annotations

import pytest
import torch

from portbench import traffic

BIG = 2 ** 31 + 977
MIX = {"kind": "train", "batch": 4, "seq": 16}


def test_train_batches_are_fresh_and_repeatable():
    a = traffic.train_batch(MIX, BIG, 0, 1000, "cpu")
    b = traffic.train_batch(MIX, BIG, 0, 1000, "cpu")
    c = traffic.train_batch(MIX, BIG, 1, 1000, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    rows = {tuple(r.tolist()) for r in torch.cat([a["tokens"],
                                                  c["tokens"]])}
    assert len(rows) == 8


@pytest.mark.parametrize("seed", [0, 2 ** 31 - 1, 2 ** 31 + 977, 2 ** 40])
def test_every_seed_gives_the_same_sizes(seed):
    a = traffic.train_batch(MIX, seed, 3, 32000, "cpu")
    assert a["tokens"].shape == a["targets"].shape == (4, 16)
    assert a["tokens"].dtype == torch.int64
    assert 0 <= int(a["tokens"].min()) and int(a["tokens"].max()) < 32000
    other = traffic.train_batch(MIX, seed + 1, 3, 32000, "cpu")
    assert not torch.equal(a["tokens"], other["tokens"])
