"""The prefill/decode-split serving engine.

Counterpart of ``tpudist/serve/engine.py`` (dense engine):

* **prefill** — one request into one slot: full causal forward over the
  padded prompt (the model's cache-aware path seeds the slot's KV
  columns; every layer's attention goes through the flash kernel), first
  token by greedy argmax at the prompt's true last position.
* **decode** — a superstep of ``decode_k`` steps over the WHOLE slot
  batch. Per-slot active masks (``torch.where`` on every state update)
  keep finished and empty slots frozen.

PyTorch runs eagerly, so the JAX engine's two compiled programs and
their pin have no counterpart here; the KV cache and the state vectors
are updated in place. Greedy decoding is a pure function of (params,
state).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from tpudist_torch.config import ModelConfig
from tpudist_torch.models import get_model
from tpudist_torch.serve import kvcache
from tpudist_torch.utils.platform import resolve_device


class ServeState(NamedTuple):
    """Device-resident serving state."""

    cache_k: torch.Tensor       # (L, slots, ...) in the storage layout
    cache_v: torch.Tensor
    lengths: torch.Tensor       # (slots,) int32: tokens in cache per slot
    last_token: torch.Tensor    # (slots,) int32: newest token, not cached
    active: torch.Tensor        # (slots,) bool: slot holds a live sequence
    remaining: torch.Tensor     # (slots,) int32: generation budget left


def init_params(model_cfg: ModelConfig, seed: int = 0, *, device=None):
    """Seeded model parameters on ``device`` (default ``cuda``), drawn
    from an explicit generator on that device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return get_model(model_cfg.name).init(model_cfg, generator=gen)


class ServeEngine:
    """Owns the state layout and runs prefill and decode on ``device``
    (default ``cuda``; ``"cpu"`` only when asked for).

    ``prompt_pad`` is the static prompt width every admission pads to;
    ``decode_k`` the superstep length (tokens per dispatch per slot);
    ``layout`` the KV storage layout (:mod:`tpudist_torch.serve.kvcache`).
    """

    def __init__(self, model_cfg: ModelConfig, *, slots: int,
                 max_seq: int, prompt_pad: int, decode_k: int = 8,
                 layout: str = "st", dtype=torch.float32, device=None):
        if slots < 1:
            raise ValueError(f"--slots must be >= 1, got {slots}")
        if decode_k < 1:
            raise ValueError(
                f"--decode-steps-per-dispatch must be >= 1, got {decode_k}")
        if not 0 < prompt_pad <= max_seq:
            raise ValueError(
                f"prompt_pad {prompt_pad} must be in (0, max_seq "
                f"{max_seq}]")
        if layout not in kvcache.KV_CACHE_LAYOUTS:
            raise ValueError(f"unknown kv-cache layout {layout!r}: "
                             f"{' | '.join(kvcache.KV_CACHE_LAYOUTS)}")
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.model = get_model(model_cfg.name)
        self.slots, self.max_seq = int(slots), int(max_seq)
        self.prompt_pad, self.decode_k = int(prompt_pad), int(decode_k)
        self.layout, self.dtype = layout, dtype
        self.spec = kvcache.CacheSpec.from_model(
            model_cfg, slots=slots, max_seq=max_seq, dtype=dtype,
            layout=layout)

    # ----------------------------------------------------------- state

    def init_state(self) -> ServeState:
        cache = kvcache.init_cache(self.spec, self.device)
        s, dev = self.slots, self.device
        return ServeState(
            cache_k=cache["k"], cache_v=cache["v"],
            lengths=torch.zeros((s,), dtype=torch.int32, device=dev),
            last_token=torch.zeros((s,), dtype=torch.int32, device=dev),
            active=torch.zeros((s,), dtype=torch.bool, device=dev),
            remaining=torch.zeros((s,), dtype=torch.int32, device=dev))

    def _canonical_cache(self, state: ServeState) -> dict:
        return {"k": kvcache.to_canonical(state.cache_k, self.layout),
                "v": kvcache.to_canonical(state.cache_v, self.layout)}

    def _tied_logits(self, params, h: torch.Tensor) -> torch.Tensor:
        return (h @ params.embed.to(self.dtype).T).to(torch.float32)

    # --------------------------------------------------------- prefill

    @torch.no_grad()
    def prefill_logits(self, params, state: ServeState, tokens,
                       prompt_len: int, slot: int) -> torch.Tensor:
        """Run the prompt through the model, seeding ``slot``'s cache
        columns ``[0, prompt_pad)`` in place; returns the logits (1,
        vocab) f32 at the prompt's true last position (the padded
        tail's hidden states exist but are never consulted)."""
        if not 0 < prompt_len <= self.prompt_pad:
            raise ValueError(f"prompt_len {prompt_len} must be in (0, "
                             f"prompt_pad {self.prompt_pad}]")
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} out of range [0, {self.slots})")
        tokens = torch.as_tensor(tokens, dtype=torch.int64).reshape(
            1, self.prompt_pad).to(self.device)
        cache = {name: c[:, slot:slot + 1]
                 for name, c in self._canonical_cache(state).items()}
        h, _ = self.model.hidden_states(
            params, tokens, self.model_cfg, dtype=self.dtype,
            kv_cache=cache, cur_index=None)
        return self._tied_logits(params, h[:, prompt_len - 1])

    @torch.no_grad()
    def prefill(self, params, state: ServeState, tokens, prompt_len: int,
                slot: int, max_new: int) -> Tuple[ServeState, torch.Tensor]:
        """Admit one request into ``slot``. ``tokens`` is the padded
        (1, prompt_pad) prompt. Returns the state and the request's FIRST
        generated token as a device scalar (``int()`` it to fence)."""
        logits = self.prefill_logits(params, state, tokens, prompt_len,
                                     slot)
        first = logits.argmax(dim=-1)[0].to(torch.int32)
        rem = max_new - 1            # the prefill itself produced token 1
        active = rem > 0 and prompt_len < self.max_seq
        state.lengths[slot] = prompt_len
        state.last_token[slot] = first
        state.active[slot] = active
        state.remaining[slot] = rem if active else 0
        return state, first

    # ---------------------------------------------------------- decode

    @torch.no_grad()
    def decode(self, params, state: ServeState
               ) -> Tuple[ServeState, torch.Tensor, torch.Tensor]:
        """One decode superstep: up to ``decode_k`` tokens for every
        active slot. Returns ``(state, tokens (decode_k, slots), valid
        (decode_k, slots))`` on the device — entries with ``valid=False``
        are placeholders (-1). Copy the tokens to the host to fence."""
        k = self.decode_k
        toks = torch.full((k, self.slots), -1, dtype=torch.int32,
                          device=self.device)
        valid = torch.zeros((k, self.slots), dtype=torch.bool,
                            device=self.device)
        st = state
        for step in range(k):
            # the JAX superstep skips a step with no active slot on the
            # device (lax.cond); here the host checks, at one device
            # sync per step. An empty batch stays empty for the rest of
            # the superstep, so the remaining steps are skipped too.
            if not bool(st.active.any()):
                break
            # inactive slots' (discarded) junk write is clamped in
            # bounds so a completed full slot never scatters past the end
            pos = st.lengths.clamp(max=self.max_seq - 1).to(torch.int64)
            h, _ = self.model.hidden_states(
                params, st.last_token[:, None].to(torch.int64),
                self.model_cfg, dtype=self.dtype,
                kv_cache=self._canonical_cache(st), cur_index=pos)
            nxt = self._tied_logits(params, h[:, 0]).argmax(dim=-1).to(
                torch.int32)
            act = st.active
            new_len = torch.where(act, st.lengths + 1, st.lengths)
            new_rem = torch.where(act, st.remaining - 1, st.remaining)
            st = ServeState(
                cache_k=st.cache_k, cache_v=st.cache_v, lengths=new_len,
                last_token=torch.where(act, nxt, st.last_token),
                # a slot completes on budget exhaustion or a full cache
                # row (forced eviction at max_seq)
                active=act & (new_rem > 0) & (new_len < self.max_seq),
                remaining=new_rem)
            toks[step] = torch.where(act, nxt, -1)
            valid[step] = act
        return st, toks, valid

    # ---------------------------------------------------------- warmup

    def warmup(self, params) -> None:
        """One dummy prefill and one decode superstep on a throwaway
        state, fenced, off the request clock: the first call builds the
        CUDA kernels (``nvcc`` at first use) and warms the allocator,
        which a cold first admission would otherwise charge to its
        TTFT."""
        state = self.init_state()
        dummy = torch.zeros((1, self.prompt_pad), dtype=torch.int64)
        state, first = self.prefill(params, state, dummy, 1, 0, 2)
        int(first)
        state, toks, valid = self.decode(params, state)
        toks.cpu()
