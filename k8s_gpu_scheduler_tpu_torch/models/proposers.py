"""Speculative-proposal sources for the paged batcher (port of the JAX
package's ``models/proposers.py``).

The verify dispatch takes a ``[n_slots, gamma]`` proposal window and
commits the accepted prefix; where the proposals come from is a
constructor argument (``ContinuousBatcher(speculative=True,
proposer=...)``) behind one small protocol:

- :class:`BigramProposer` — prompt lookup: the latest earlier occurrence
  of the stream's last token, served by an incremental bigram → latest-
  position index. The default.
- :class:`NgramProposer` — the same index keyed on (n-1)-token contexts.
- :class:`DraftModelProposer` — a small ``LlamaConfig`` draft model run
  as one batched torch function over all active slots per verify step
  (gamma dense forwards over a ``[B, ctx + gamma]`` window). It is the
  one distributional proposer: it returns the draft distributions q it
  sampled from, and the verify applies the full ``min(1, p/q)`` accept
  and ``max(0, p - q)`` residual rule.

A deterministic proposer is the q = delta(prop) special case of the
rejection-sampling rule: the accept probability is ``p[prop]`` and the
residual is p with the proposed token zeroed. Either way the emitted
stream is distributed as the target sampler's; greedy engines
(temperature 0) accept by exact match.

Determinism: host-mirror proposers are pure functions of the committed
streams; the draft proposer draws from a ``torch.Generator`` seeded from
(its seed, the engine's dispatch counter), so replaying the same
submissions yields the same proposals.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from .llama import Llama, LlamaConfig, forward


class SlotView:
    """What a proposer may read about one active slot: the committed
    stream (prompt + emitted tokens) and the identity needed to keep
    per-slot state coherent across slot reuse."""

    __slots__ = ("slot", "rid", "prompt", "out")

    def __init__(self, slot: int, rid: int,
                 prompt: Sequence[int], out: Sequence[int]) -> None:
        self.slot = int(slot)
        self.rid = int(rid)
        self.prompt = prompt
        self.out = out


class Proposer(Protocol):
    """Proposal source protocol. ``name`` labels the accept-rate gauges;
    ``distributional`` says whether proposals come with explicit q
    distributions (full ``min(1, p/q)`` rejection) or are deterministic
    (delta-q); ``batched`` selects per-slot calls with per-request error
    isolation, or one batched call per verify step."""

    name: str
    distributional: bool
    batched: bool

    def propose(self, view: SlotView, gamma: int) -> List[int]:
        """gamma proposal tokens for one slot (``batched = False``)."""
        ...

    def propose_batch(
        self, views: Sequence[SlotView], gamma: int, seed: int,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(props [len(views), gamma] int32, q [len(views), gamma, vocab]
        float32 or None) for all active slots at once (``batched =
        True``). ``seed`` is the engine's dispatch counter."""
        ...

    def drop(self, slot: int) -> None:
        """Forget per-slot state (slot freed or failed)."""
        ...


class NgramProposer:
    """Prompt-lookup proposals by the latest (n-1)-token context match
    against the slot's committed stream.

    A per-slot incremental context → latest-position index keeps the
    deferred-tail invariant: the n-gram ending at the current tail is
    recorded only once a token lands after it, so a lookup of the tail
    context answers with the latest *previous* occurrence. Steady-state
    cost is O(tokens committed since the last dispatch) per slot; the
    index rebuilds from the prompt when the slot changes hands. No match
    gives zeros, which the verify simply rejects."""

    distributional = False
    batched = False

    def __init__(self, n: int = 3) -> None:
        if n < 2:
            raise ValueError(f"n-gram proposer needs n >= 2, got {n}")
        self.n = int(n)
        self.name = f"{self.n}gram"
        # slot -> (rid, history, context tuple -> latest tail index)
        self._mirror: Dict[int, Tuple[int, list, dict]] = {}

    def _append(self, hist: list, idx: dict, tk: int) -> None:
        if len(hist) >= self.n:
            idx[tuple(hist[-self.n:])] = len(hist) - 1
        hist.append(tk)

    def propose(self, view: SlotView, gamma: int) -> List[int]:
        mirror = self._mirror.get(view.slot)
        if mirror is None or mirror[0] != view.rid:  # slot reassigned
            mirror = (view.rid, [], {})
            self._mirror[view.slot] = mirror
            for tk in view.prompt:
                self._append(mirror[1], mirror[2], int(tk))
        _, hist, idx = mirror
        base = len(view.prompt)
        for tk in view.out[len(hist) - base:]:
            self._append(hist, idx, int(tk))
        if len(hist) < self.n:
            return [0] * gamma
        j = idx.get(tuple(hist[-self.n:]))
        if j is None:
            return [0] * gamma
        guess = [int(tk) for tk in hist[j + 1:j + 1 + gamma]]
        return guess + [0] * (gamma - len(guess))

    def drop(self, slot: int) -> None:
        self._mirror.pop(slot, None)


class BigramProposer(NgramProposer):
    """The bigram lookup (n = 2), the default proposer."""

    def __init__(self) -> None:
        super().__init__(n=2)
        self.name = "bigram"


class DraftModelProposer:
    """Small-draft-model proposals with explicit q distributions.

    One batched torch function per verify step: each slot's last ``ctx``
    committed tokens, right-padded into a ``[B, ctx + gamma]`` window, run
    through the draft's dense ``forward`` gamma times; step i reads the
    logits at each slot's tail, draws the proposal (argmax at temperature
    0, else temperature/top-k sampling by the Gumbel-max trick with noise
    from one generator seeded from (seed, dispatch)), writes it into the
    window and returns the distribution it drew from as q. A draft that
    shares the target's weights and sampler gives q == p, so every
    proposal accepts. The draft must share the target's vocab and live on
    the engine's device."""

    distributional = True
    batched = True
    name = "draft"

    def __init__(self, cfg: LlamaConfig, model: Llama,
                 temperature: float = 0.0, top_k: int = 0, ctx: int = 32,
                 seed: int = 0) -> None:
        if ctx < 1:
            raise ValueError(f"draft context must be >= 1, got {ctx}")
        self.cfg = cfg
        self.model = model
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.ctx = int(min(ctx, cfg.max_seq))
        self.seed = int(seed)

    @torch.no_grad()
    def draft(self, tokens: torch.Tensor, lens: torch.Tensor, gamma: int,
              dispatch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, ctx + gamma] int64 (each row's context right-padded),
        lens [B] int64 context lengths (>= 1) → (props [B, gamma] int32,
        q [B, gamma, vocab] f32)."""
        from .serving import _generator, _sample_tokens, _shaped_logits

        dev = tokens.device
        rows = torch.arange(tokens.shape[0], device=dev)
        gen = (_generator(dev, self.seed, 3, dispatch)
               if self.temperature > 0 else None)
        props, qs = [], []
        for i in range(gamma):
            logits = forward(self.model, tokens)              # [B, span, V]
            row = logits[rows, lens + i - 1].float()          # [B, V]
            if self.temperature <= 0.0:
                nxt = torch.argmax(row, dim=-1)
                q = torch.nn.functional.one_hot(
                    nxt, self.cfg.vocab).to(torch.float32)
            else:
                adj = _shaped_logits(row, self.temperature, self.top_k)
                q = torch.softmax(adj, dim=-1)
                nxt = _sample_tokens(adj, gen, 1.0, 0)
            props.append(nxt)
            qs.append(q)
            tokens = tokens.clone()
            tokens[rows, lens + i] = nxt
        return (torch.stack(props, dim=1).to(torch.int32),
                torch.stack(qs, dim=1))

    def propose_batch(
        self, views: Sequence[SlotView], gamma: int, seed: int,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        span = self.ctx + gamma
        tokens = np.zeros((len(views), span), np.int64)
        lens = np.zeros((len(views),), np.int64)
        for i, v in enumerate(views):
            tail = (list(v.prompt) + list(v.out))[-self.ctx:]
            tokens[i, :len(tail)] = tail
            lens[i] = len(tail)
        dev = self.model.device
        props, q = self.draft(torch.as_tensor(tokens, device=dev),
                              torch.as_tensor(lens, device=dev), gamma, seed)
        # The draft's proposals feed the host's verify window, as in JAX:
        # graftcheck: ignore[host-sync]
        return props.cpu().numpy(), q.cpu().numpy()

    def drop(self, slot: int) -> None:  # stateless per slot
        pass


def resolve_proposer(spec) -> "Proposer":
    """None or "bigram" → the bigram default; "ngram"/"ngram:N" → n-gram
    lookup; a Proposer instance passes through (the only way to get a
    draft proposer — it needs weights)."""
    if spec is None or spec == "bigram":
        return BigramProposer()
    if isinstance(spec, str):
        if spec == "ngram":
            return NgramProposer()
        if spec.startswith("ngram:"):
            return NgramProposer(int(spec.split(":", 1)[1]))
        raise ValueError(
            f"unknown proposer {spec!r}: expected 'bigram', 'ngram', "
            f"'ngram:N', or a Proposer instance")
    for attr in ("name", "distributional", "batched", "drop"):
        if not hasattr(spec, attr):
            raise ValueError(
                f"proposer {spec!r} does not implement the Proposer "
                f"protocol (missing {attr!r})")
    return spec
