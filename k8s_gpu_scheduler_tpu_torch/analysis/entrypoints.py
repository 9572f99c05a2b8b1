"""The port's dispatch bodies and audit scenarios, as registries.

- ``DISPATCH_BODIES``: the functions whose work the card runs, by file —
  the engine's five dispatches and the seven kernel wrappers (K1–K7).
  The AST passes read it (astlint.py, lockorder.py); eager PyTorch has
  no ``jit`` wrapper to find them by, so they are listed.
- ``alias_scenarios()``: every dispatch that runs with shared prefix
  pages mounted in the pool (analysis/alias.py).
- ``steady_scenarios()``: the single-card steady states (analysis/
  steady.py) — the engines, ``generate`` and the train step.

A scenario is ``(name, build)``; ``build(device, size)`` makes a fresh
engine on the explicit device at ``size`` (``TINY`` by default; chip_smoke
passes the serve config's full widths) and returns the audit's operands.
Imports are lazy: the fast passes import this module, and nothing here
builds a model until a scenario runs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

# file (package-qualified) -> the dispatch bodies it defines.
DISPATCH_BODIES: Dict[str, Tuple[str, ...]] = {
    "k8s_gpu_scheduler_tpu_torch/models/serving.py": (
        "_decode_chunk_paged_fn", "_verify_chunk_paged_fn",
        "_prefill_multi_paged_fn", "_decode_chunk_fn", "_prefill_multi_fn"),
    "k8s_gpu_scheduler_tpu_torch/ops/decode_attention.py": (
        "paged_decode_attention", "paged_prefill_attention",
        "paged_verify_attention", "flash_decode_attention"),
    "k8s_gpu_scheduler_tpu_torch/ops/flash_attention.py": (
        "launch_forward", "launch_backward_dq", "launch_backward_dkv"),
}

# The tiny config the CPU tests and the card tests audit at: 2 layers, a
# 64-wide head (the kernels' smallest) over 2 query and 1 kv heads, f32.
TINY_CFG = dict(vocab=256, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
                d_ff=256, max_seq=128)
UNIQ = 4            # tokens a request has after the shared system prompt
TRAIN_LAYERS = 2    # the train step's depth at every size


@dataclasses.dataclass(frozen=True)
class ScenarioSize:
    """How big a scenario's engine is. The default is the tiny config at
    page 8; chip_smoke phase 21 passes the serve config's full widths
    (``cfg``, ``make_model`` drawing the weights on the card, page 64,
    a 384-token system prompt, gamma 4)."""
    cfg: Optional[object] = None            # LlamaConfig; None: tiny, f32
    make_model: Optional[Callable] = None   # (cfg, device) -> Llama
    page_size: int = 8
    sys_len: int = 8                        # shared prompt, page multiple
    kv_dtype: Optional[str] = "int8"
    max_len: int = 64
    chunk: int = 2
    gamma: int = 2
    train_bt: Tuple[int, int] = (2, 16)


TINY = ScenarioSize()


def _cfg(size: ScenarioSize):
    if size.cfg is not None:
        return size.cfg
    import torch

    from ..models.llama import LlamaConfig

    return LlamaConfig(**TINY_CFG, dtype=torch.float32, decode_attn="fused",
                       remat=False)


def _model(size: ScenarioSize, cfg, device):
    if size.make_model is not None:
        return size.make_model(cfg, device)
    import torch

    from ..models.llama import init_params

    return init_params(cfg, torch.Generator().manual_seed(0), device)


def _engine(device, size: ScenarioSize, **kw):
    """A fresh engine of ``size`` on ``device`` (paged unless ``kw`` says
    otherwise) and an rng for its traffic."""
    import numpy as np

    from ..models.serving import ContinuousBatcher

    cfg = _cfg(size)
    opts = dict(n_slots=2, max_len=size.max_len, chunk=size.chunk,
                prefill_bucket=size.page_size, kv_dtype=size.kv_dtype,
                device=device)
    if kw.get("kv_layout", "paged") == "paged":
        opts.update(kv_layout="paged", page_size=size.page_size)
    opts.update(kw)
    eng = ContinuousBatcher(_model(size, cfg, device), cfg, **opts)
    return eng, np.random.default_rng(0)


def _tokens(rng, eng, n: int) -> list:
    return [int(t) for t in rng.integers(0, eng.cfg.vocab, n)]


def _pools(eng) -> list:
    return [t for t in (eng._k, eng._v, eng._ks, eng._vs) if t is not None]


def _shared(eng) -> list:
    return sorted({p for pages in eng._slot_shared.values() for p in pages})


def _active(eng):
    import numpy as np

    return np.asarray([s in eng._slot_req for s in range(eng.n_slots)])


# -- shared-page (copy-on-write) scenarios ------------------------------------

def _prefix_engine(device, size: ScenarioSize, **kw):
    """A warmed prefix-cache engine whose tree holds the system prompt's
    pages, with a live request MOUNTING them mid-decode."""
    eng, rng = _engine(device, size, prefix_cache=True, **kw)
    system = _tokens(rng, eng, size.sys_len)
    eng.submit(system + _tokens(rng, eng, 3), max_new=2)
    eng.run()                        # the reap donates the system pages
    eng.submit(system + _tokens(rng, eng, UNIQ),
               max_new=4 * size.chunk + 1)
    eng.step()
    if not _shared(eng):
        raise RuntimeError("the scenario must actually share a page")
    return eng, rng


def _tail_prefill(eng, rng, shared: list):
    """The tail-prefill dispatch (K2) of a throwaway tail page over the
    mounted prefix ``shared`` (padded to the engine's hb bucket)."""
    import numpy as np

    from ..models.paging import NULL_PAGE

    own = eng._alloc.alloc(1)        # a throwaway tail page to scatter to
    eng._alloc.retain(shared)        # mirror admission's mount
    hb = eng._hb_bucket(len(shared))
    row = shared + [NULL_PAGE] * (hb - len(shared))
    ps = eng.page_size
    kw = dict(slots=np.ones(2, np.int32),
              page_ids=np.full((2, 1), own[0], np.int32),
              prefix_tables=np.asarray([row] * 2, np.int32),
              hit_lens=np.full(2, len(shared) * ps, np.int32),
              tokens=np.asarray([_tokens(rng, eng, ps)] * 2, np.int32),
              tail_lens=np.full(2, min(4, ps), np.int32),
              seed=(eng.seed, 1, 99))
    return lambda: eng._op_prefill(**kw)


def _alias_prefill(device, size: ScenarioSize = TINY):
    """The tail prefill with a mounted shared prefix: its page-granular
    scatter must touch only the entry's OWN page."""
    eng, rng = _prefix_engine(device, size)
    shared = _shared(eng)
    return _tail_prefill(eng, rng, shared), _pools(eng), shared


def _alias_prefill_decoded(device, size: ScenarioSize = TINY):
    """The tail prefill over a mounted prefix that INCLUDES a decoded-
    suffix page (turn 1 of a conversation reaped with donate_decoded):
    the copy-on-write proof for both halves of the multi-turn path."""
    eng, rng = _engine(device, size, prefix_cache=True)
    ps = eng.page_size
    first = _tokens(rng, eng, 2 * ps)
    eng.submit(first, max_new=ps + ps // 2)                 # turn 1
    done: dict = {}
    while eng.pending:
        done.update(eng.step())
    (reply,) = done.values()
    if eng.pool_metrics()["decoded_pages_donated_total"] < 1:
        raise RuntimeError("the scenario must donate a decoded page")
    eng.submit(first + reply + _tokens(rng, eng, UNIQ),
               max_new=4 * size.chunk + 1)                  # turn 2
    eng.step()
    shared = _shared(eng)
    if len(shared) < 3:
        raise RuntimeError("turn 2 must mount prompt AND decoded pages")
    return _tail_prefill(eng, rng, shared), _pools(eng), shared


def _alias_decode(device, size: ScenarioSize = TINY):
    """A decode chunk (K1) over a block table whose prefix rows are
    shared: the per-slot write at ``lens`` lands past the mounted prefix."""
    eng, _ = _prefix_engine(device, size)
    active = _active(eng)
    return (lambda: eng._op_decode(active, (eng.seed, 0, 99)), _pools(eng),
            _shared(eng))


def _alias_promoted(device, size: ScenarioSize = TINY):
    """A decode chunk over a block table whose mounted prefix pages came
    back through a host-tier demote→promote round trip: build time checks
    the promoted pages hold exactly the donated bytes (readback, host
    tier, upload into FRESH page ids), and the audit then proves the next
    dispatch leaves them untouched."""
    eng, rng = _engine(device, size, prefix_cache=True, kv_tiering=True,
                       dram_pages=32, n_pages=10)
    ps = eng.page_size
    prompts = [_tokens(rng, eng, 3 * ps + ps // 2) for _ in range(3)]
    eng.submit(prompts[0], max_new=8)
    eng.run()                        # the reap donates prompts[0]'s path
    path0 = eng._prefix.match(prompts[0])
    if len(path0) < 2:
        raise RuntimeError("the scenario must donate a multi-page path")
    before = [t[:, path0].clone() for t in _pools(eng)]
    for p in prompts[1:]:            # pool pressure: LRU demotion
        eng.submit(p, max_new=8)
        eng.run()
    if not eng.pool_metrics()["page_demotions_total"]:
        raise RuntimeError("the scenario must demote")
    eng.submit(prompts[0], max_new=4 * size.chunk + 1)
    eng.step()                       # promote + mount, then mid-decode
    if not eng.pool_metrics()["page_promotions_total"]:
        raise RuntimeError("the scenario must serve through a promotion")
    path1 = eng._prefix.match(prompts[0])
    if len(path1) != len(path0) or not set(path1) <= set(_shared(eng)):
        raise RuntimeError("the whole promoted path must be mounted")
    from .alias import _same_bytes

    if not all(_same_bytes(b, t[:, path1])
               for b, t in zip(before, _pools(eng))):
        raise RuntimeError("promoted pages differ from the donated bytes")
    active = _active(eng)
    return (lambda: eng._op_decode(active, (eng.seed, 0, 99)), _pools(eng),
            _shared(eng))


def _alias_verify(device, size: ScenarioSize = TINY):
    """A speculative verify dispatch (K3) over shared prefix rows: the
    whole 1+gamma window, including the overshoot a rejection rewinds,
    lands past the mounted prefix."""
    import numpy as np

    eng, _ = _prefix_engine(device, size, speculative=True,
                            gamma=size.gamma)
    active = _active(eng)
    props = np.zeros((eng.n_slots, eng.gamma), np.int32)
    eff = np.full(eng.n_slots, eng.gamma, np.int32)
    return (lambda: eng._op_verify(props, active, (eng.seed, 2, 99), eff,
                                   None), _pools(eng), _shared(eng))


def alias_scenarios() -> List[Tuple[str, Callable]]:
    """(name, build) pairs for the shared-page audit: every dispatch that
    runs with aliased prefix pages in its pool."""
    return [
        ("batcher_prefill_paged_prefix", _alias_prefill),
        ("batcher_prefill_prefix_kernel", _alias_prefill_decoded),
        ("batcher_decode_paged_prefix", _alias_decode),
        ("batcher_decode_paged_promoted", _alias_promoted),
        ("batcher_verify_paged_prefix", _alias_verify),
    ]


# -- steady-state scenarios ---------------------------------------------------

def _steady_engine(device, size: ScenarioSize, shared_prefix=False,
                   long_prompt=False, **kw):
    """Two requests decoding (behind a donated system prompt with
    ``shared_prefix``; beside a third prompt prefilled a page a step with
    ``long_prompt``): the warm-up admits them and runs three steps, each
    steady function is one more step, with no admission."""
    from .steady import engine_tensors

    if kw.get("speculative"):
        kw.setdefault("gamma", size.gamma)
    if long_prompt:
        kw.update(n_slots=3, prefill_chunk_tokens=size.page_size)
    eng, rng = _engine(device, size, **kw)
    system = _tokens(rng, eng, size.sys_len)
    budget = size.max_len - size.sys_len - UNIQ - size.gamma - 1

    def warmup():
        if shared_prefix:
            eng.submit(system + _tokens(rng, eng, 3), max_new=2)
            eng.run()
        for _ in range(2):
            eng.submit(system + _tokens(rng, eng, UNIQ),
                       max_new=budget)
        if long_prompt:
            eng.submit(_tokens(rng, eng, 6 * size.page_size), max_new=2)
        for _ in range(3):
            eng.step()

    return warmup, [eng.step] * 3, lambda: engine_tensors(eng)


def _steady(**kw):
    return lambda device, size=TINY: _steady_engine(device, size, **kw)


def _generate_steady(device, size: ScenarioSize = TINY):
    """``generate``'s decode loop over a cache that outlives the call.
    The warm-up runs ``generate`` once (its prefill and decode
    instantiations), then prefills a cache of its own; each steady
    function is one of ``generate``'s per-token steps on that cache
    (``forward_with_cache`` of the last token, K4), which writes its K/V
    in place. The cache is what is tracked: ``generate`` itself makes a
    new one on every call (``init_cache``)."""
    import torch

    from ..models.serving import forward_with_cache, generate, init_cache

    cfg = _cfg(size)
    model = _model(size, cfg, device)
    prompt = torch.randint(0, cfg.vocab, (2, size.sys_len + UNIQ),
                           generator=torch.Generator().manual_seed(0)
                           ).to(model.device)
    state: dict = {}

    @torch.no_grad()
    def forward(tokens):
        logits, state["cache"] = forward_with_cache(model, tokens, cfg,
                                                    state["cache"])
        state["last"] = torch.argmax(logits[:, -1], dim=-1)

    def warmup():
        generate(model, prompt, cfg, max_new=3, max_len=size.max_len)
        state["cache"] = init_cache(cfg, prompt.shape[0], size.max_len,
                                    device=model.device)
        forward(prompt)

    def step():
        forward(state["last"][:, None])

    return warmup, [step] * 3, lambda: {
        "cache:k": state["cache"]["k"], "cache:v": state["cache"]["v"]}


def _train_steady(device, size: ScenarioSize = TINY):
    import torch

    from ..models.llama import make_optimizer, make_train_step
    from .steady import train_tensors

    cfg = dataclasses.replace(_cfg(size), n_layers=TRAIN_LAYERS,
                              attn_impl="flash")
    model = _model(size, cfg, device)
    opt = make_optimizer(model, 3e-4)
    step = make_train_step(cfg, None, opt)
    B, T = size.train_bt
    tokens = torch.randint(0, cfg.vocab, (B, T),
                           generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens.to(device),
             "targets": torch.roll(tokens, -1, dims=1).to(device)}

    def call():
        step(model, batch)

    return call, [call] * 3, lambda: train_tensors(model, opt)


def _traced(device, size: ScenarioSize = TINY):
    from ..obs import Tracer, VirtualClock

    clock = VirtualClock()
    return _steady_engine(device, size, tracer=Tracer(clock=clock),
                          clock=clock)


def steady_scenarios() -> List[Tuple[str, Callable]]:
    """(name, build) pairs for the steady-state audit: the single-card
    steady states of the JAX package's recompile scenarios, and the train
    step."""
    return [
        ("batcher_steady_decode", _steady(kv_layout="contiguous")),
        ("batcher_steady_decode_paged", _steady()),
        ("batcher_steady_decode_paged_traced", _traced),
        ("batcher_steady_decode_paged_prefix",
         _steady(shared_prefix=True, prefix_cache=True)),
        ("batcher_steady_decode_paged_tiered",
         _steady(shared_prefix=True, prefix_cache=True, kv_tiering=True,
                 dram_pages=32)),
        ("batcher_steady_decode_paged_spec", _steady(speculative=True)),
        ("batcher_steady_decode_paged_spec_sampled",
         _steady(speculative=True, temperature=0.7, top_k=4)),
        ("batcher_steady_mixed_chunked", _steady(long_prompt=True)),
        ("batcher_steady_prefix_kernel",
         _steady(shared_prefix=True, prefix_cache=True,
                 donate_decoded=True)),
        ("generate_steady_state", _generate_steady),
        ("train_steady_state", _train_steady),
    ]
