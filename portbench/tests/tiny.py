"""Tiny cells built in memory, run on the CPU through the same harness as
the benchmark's cells."""
from __future__ import annotations

from portbench.cell import Cell


def tiny_config(dtype: str = "float32", **over) -> dict:
    c = {"vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
         "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "max_position_embeddings": 256,
         "rope_theta": 1e6, "rms_norm_eps": 1e-6, "torch_dtype": dtype}
    c.update(over)
    return c


TRAIN = {"kind": "train", "batch": 4, "seq": 32}


def train_cell(limits=None, mix=TRAIN, **cfg) -> Cell:
    wl = {"limits": limits or {"loss_gap": 1e-4, "grad_gap": 1e-3,
                               "change_gap": 1e-3},
          "trace_steps": [1, 1]}
    e2e = [{"name": n, "unit": "u"} for n in ("train_tok_s", "setup_s")]
    return Cell("tiny.train", tiny_config(**cfg), mix, wl, e2e, [])
