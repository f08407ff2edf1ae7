"""The prefill/decode-split serving engine: one prefill program and one
decode program per ladder rung, captured as CUDA graphs on the card.

Counterpart of ``tpudist/serve/engine.py`` (dense engine), whose two
jitted programs (prefill, and decode per ladder rung) become CUDA graphs
here:

* **prefill** — one request into one slot: full causal forward over the
  padded prompt into a one-slot scratch cache (every layer's attention
  through the flash kernel), the first token by greedy argmax at the
  prompt's true last position (a device gather), then the scratch
  copied into the slot's cache columns ``[0, prompt_pad)`` by a
  device-indexed ``index_copy_`` and the slot's state set by device
  writes. Slot, prompt length and budget are device-resident ints, as
  the JAX engine traces them, so every admission replays one graph.
* **decode** — a superstep of ``k`` steps over the WHOLE slot batch,
  ``k`` a rung of ``adapt_ladder`` (default ``(decode_k,)``). Per-slot
  active masks (``torch.where`` on every state update) keep finished and
  empty slots frozen. Where the JAX superstep skips a step with no
  active slot on the device (``lax.cond``), every step runs here and the
  masks freeze the batch, so a superstep has no host sync. The tokens,
  valid flags, ``lengths``, ``last_token``, ``active`` and ``remaining``
  equal the JAX engine's; the KV cache differs only at positions at or
  past a slot's length (the masked junk write, clamped to ``max_seq - 1``
  for a full slot), which nothing reads before it is written again.

On ``cuda``, :meth:`ServeEngine.warmup` runs each body once eagerly on a
side stream (the first call builds the CUDA kernels and loads their
modules, which a capture cannot do) and then captures it into a
``torch.cuda.CUDAGraph`` (the decode graphs share one memory pool);
``prefill``/``decode`` copy their small inputs into the graphs' static
buffers and replay. There is no eager route on the card: a capture or
replay that fails raises. On the CPU (asked for explicitly) the same
bodies run eagerly. :meth:`compile_counts` counts captures (the CPU: each
body's first call) and :meth:`assert_two_programs` pins them, as the JAX
engine pins its traces.

The engine owns the KV cache and the state vectors, which the graphs
read and write in place: :meth:`init_state` resets them and returns
them, and ``prefill``/``decode`` refuse another state, or params other
than those the programs were built on. Greedy decoding is a pure
function of (params, state).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from tpudist_torch.config import ModelConfig
from tpudist_torch.models import get_model
from tpudist_torch.ops.cuda import flash_attention as fa
from tpudist_torch.serve import kvcache
from tpudist_torch.utils.platform import resolve_device


class ServeState(NamedTuple):
    """Device-resident serving state, owned by the engine."""

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


def _param_ptrs(params) -> Tuple[int, ...]:
    return tuple(p.data_ptr() for p in params.parameters())


class ServeEngine:
    """Owns the state and the programs, and runs prefill and decode on
    ``device`` (default ``cuda``; ``"cpu"`` only when asked for).

    ``prompt_pad`` is the static prompt width every admission pads to;
    ``decode_k`` the superstep length (tokens per dispatch per slot);
    ``layout`` the KV storage layout (:mod:`tpudist_torch.serve.kvcache`).
    ``adapt_ladder`` is the graceful-degradation rung set
    (:func:`tpudist_torch.serve.resilience.default_ladder`): one decode
    program per rung, all built at warmup, so a downshift switches
    programs and never builds one.
    """

    def __init__(self, model_cfg: ModelConfig, *, slots: int,
                 max_seq: int, prompt_pad: int, decode_k: int = 8,
                 layout: str = "st", dtype=torch.float32, device=None,
                 adapt_ladder: Optional[Sequence[int]] = None):
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
        ladder = tuple(int(k) for k in (adapt_ladder or (decode_k,)))
        if not ladder or ladder[0] != int(decode_k):
            raise ValueError(
                f"adapt_ladder {ladder} must start at decode_k "
                f"{decode_k} (level 0 = full service)")
        if any(k < 1 for k in ladder) \
                or any(a <= b for a, b in zip(ladder, ladder[1:])):
            raise ValueError(
                f"adapt_ladder {ladder} must be strictly descending "
                f"positive superstep lengths")
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.model = get_model(model_cfg.name)
        self.slots, self.max_seq = int(slots), int(max_seq)
        self.prompt_pad, self.decode_k = int(prompt_pad), int(decode_k)
        self.ladder = ladder
        self.layout, self.dtype = layout, dtype
        self.spec = kvcache.CacheSpec.from_model(
            model_cfg, slots=slots, max_seq=max_seq, dtype=dtype,
            layout=layout)
        dev, s = self.device, self.slots
        cache = kvcache.init_cache(self.spec, dev)
        self._state = ServeState(
            cache_k=cache["k"], cache_v=cache["v"],
            lengths=torch.zeros((s,), dtype=torch.int32, device=dev),
            last_token=torch.zeros((s,), dtype=torch.int32, device=dev),
            active=torch.zeros((s,), dtype=torch.bool, device=dev),
            remaining=torch.zeros((s,), dtype=torch.int32, device=dev))
        # the prefill's static inputs: the padded prompt, and (prompt_len,
        # slot, max_new) as device ints; and its one-slot scratch cache
        self._tokens = torch.zeros((1, self.prompt_pad), dtype=torch.int64,
                                   device=dev)
        self._args = torch.zeros((3,), dtype=torch.int64, device=dev)
        l, _, _, h, d = self.spec.canonical_shape
        self._scratch = {
            name: torch.zeros((l, 1, self.prompt_pad, h, d), dtype=dtype,
                              device=dev) for name in ("k", "v")}
        self._params: Optional[Tuple[int, ...]] = None
        self.prefill_traces: list = []   # captures (CPU: first calls)
        self.decode_traces: list = []
        self._graphs: Dict[str, "torch.cuda.CUDAGraph"] = {}
        self._outputs: Dict[str, tuple] = {}
        self._captured_launches: Dict[str, int] = {}
        self._replays: Dict[str, int] = {}
        self._eager_launches = 0
        self.capture_s = 0.0             # warmup's capture wall time
        self.graph_pool_bytes = 0        # device memory the captures hold
        self.last_logits: Optional[torch.Tensor] = None

    # ----------------------------------------------------------- state

    def init_state(self) -> ServeState:
        """Reset the engine's state in place (empty slots, zeroed cache)
        and return it."""
        for t in self._state:
            t.zero_()
        return self._state

    def _check_call(self, params, state: ServeState) -> None:
        if state is not self._state:
            raise ValueError(
                "state is not this engine's: the engine owns its KV cache "
                "and state vectors (use init_state())")
        ptrs = _param_ptrs(params)
        if self._params is None:
            self._params = ptrs          # the first call (warmup) pins
        elif ptrs != self._params:
            raise ValueError(
                "params are not those this engine's programs were built "
                "on; build another engine for other params")

    def _canonical_cache(self, state: ServeState) -> dict:
        return {"k": kvcache.to_canonical(state.cache_k, self.layout),
                "v": kvcache.to_canonical(state.cache_v, self.layout)}

    def _tied_logits(self, params, h: torch.Tensor) -> torch.Tensor:
        return (h @ params.embed.to(self.dtype).T).to(torch.float32)

    # -------------------------------------------------------- programs

    def _prefill_body(self, params) -> Tuple[torch.Tensor, torch.Tensor]:
        """The prefill program, on the static inputs: returns (first
        token (1,) int32, logits (1, vocab) f32 at the prompt's last
        position) and writes the slot's cache columns and state."""
        plen, slot, max_new = self._args[0:1], self._args[1:2], \
            self._args[2:3]
        h, _ = self.model.hidden_states(
            params, self._tokens, self.model_cfg, dtype=self.dtype,
            kv_cache=self._scratch, cur_index=None)
        # the padded tail's hidden states exist but are never consulted
        logits = self._tied_logits(params, h[0].index_select(0, plen - 1))
        first = logits.argmax(dim=-1).to(torch.int32)
        st = self._state
        for name, full in (("k", st.cache_k), ("v", st.cache_v)):
            kvcache.to_canonical(full, self.layout)[
                :, :, :self.prompt_pad].index_copy_(1, slot,
                                                    self._scratch[name])
        rem = max_new - 1            # the prefill itself produced token 1
        active = (rem > 0) & (plen < self.max_seq)
        st.lengths.index_copy_(0, slot, plen.to(torch.int32))
        st.last_token.index_copy_(0, slot, first)
        st.active.index_copy_(0, slot, active)
        st.remaining.index_copy_(
            0, slot, torch.where(active, rem, 0).to(torch.int32))
        return first, logits

    def _decode_body(self, params, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The decode program for rung ``k``: ``k`` masked steps over the
        slot batch; returns (tokens (k, slots) int32, valid (k, slots))
        and writes the state."""
        st = self._state
        cache = self._canonical_cache(st)
        lengths, last, act, rem = (st.lengths, st.last_token, st.active,
                                   st.remaining)
        toks, valid = [], []
        for _ in range(k):
            # inactive slots' (discarded) junk write is clamped in
            # bounds so a completed full slot never scatters past the end
            pos = lengths.clamp(max=self.max_seq - 1).to(torch.int64)
            h, _ = self.model.hidden_states(
                params, last[:, None].to(torch.int64), self.model_cfg,
                dtype=self.dtype, kv_cache=cache, cur_index=pos)
            nxt = self._tied_logits(params, h[:, 0]).argmax(dim=-1).to(
                torch.int32)
            new_len = torch.where(act, lengths + 1, lengths)
            new_rem = torch.where(act, rem - 1, rem)
            toks.append(torch.where(act, nxt, -1))
            valid.append(act)
            last = torch.where(act, nxt, last)
            # a slot completes on budget exhaustion or a full cache row
            # (forced eviction at max_seq)
            act = act & (new_rem > 0) & (new_len < self.max_seq)
            lengths, rem = new_len, new_rem
        # stacked before the state is written: valid[0] IS st.active
        out = torch.stack(toks), torch.stack(valid)
        st.lengths.copy_(lengths)
        st.last_token.copy_(last)
        st.active.copy_(act)
        st.remaining.copy_(rem)
        return out

    def _eager(self, body: Callable[[], tuple]) -> tuple:
        n0 = fa.launches
        out = body()
        self._eager_launches += fa.launches - n0
        return out

    def _run(self, name: str, body: Callable[[], tuple]) -> tuple:
        """Program ``name``: its graph replayed on the card, its body run
        on the CPU (where each body's first call counts as its build)."""
        if self.device.type == "cuda":
            graph = self._graphs.get(name)
            if graph is None:
                raise RuntimeError(
                    f"serve program {name} is not captured: call "
                    f"warmup(params) first")
            graph.replay()
            self._replays[name] += 1
            return self._outputs[name]
        if name not in self.prefill_traces + self.decode_traces:
            self._note_build(name)
        return self._eager(body)

    def _note_build(self, name: str) -> None:
        (self.prefill_traces if name == "prefill"
         else self.decode_traces).append(name)

    def _programs(self, params) -> Dict[str, Callable[[], tuple]]:
        progs = {"prefill": lambda: self._prefill_body(params)}
        for k in self.ladder:
            progs[f"decode_k{k}"] = \
                lambda k=k: self._decode_body(params, k)
        return progs

    def _capture(self, params) -> None:
        """Eager warm-up of every body on a side stream, then one graph
        each; the decode graphs share a memory pool."""
        dev = self.device
        progs = self._programs(params)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for body in progs.values():
                self._eager(body)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        decode_pool = torch.cuda.graph_pool_handle()
        for name, body in progs.items():
            graph = torch.cuda.CUDAGraph()
            n0 = fa.launches
            with torch.cuda.graph(graph, stream=side,
                                  pool=None if name == "prefill"
                                  else decode_pool):
                out = body()
            # the capture recorded these launches; each replay runs them
            self._captured_launches[name] = fa.launches - n0
            fa.launches = n0
            self._graphs[name], self._outputs[name] = graph, out
            self._replays[name] = 0
            self._note_build(name)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        self.graph_pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    # ------------------------------------------------------ public API

    def _set_prefill_inputs(self, tokens, prompt_len: int, slot: int,
                            max_new: int) -> None:
        if not 0 < prompt_len <= self.prompt_pad:
            raise ValueError(f"prompt_len {prompt_len} must be in (0, "
                             f"prompt_pad {self.prompt_pad}]")
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} out of range [0, {self.slots})")
        self._tokens.copy_(torch.as_tensor(tokens, dtype=torch.int64)
                           .reshape(1, self.prompt_pad))
        self._args.copy_(torch.tensor([prompt_len, slot, max_new],
                                      dtype=torch.int64))

    @torch.no_grad()
    def prefill(self, params, state: ServeState, tokens, prompt_len: int,
                slot: int, max_new: int) -> Tuple[ServeState, torch.Tensor]:
        """Admit one request into ``slot``. ``tokens`` is the padded
        (1, prompt_pad) prompt. Returns the state and the request's FIRST
        generated token as a device scalar (``int()`` it to fence; on the
        card it is the graph's output, overwritten by the next prefill).
        ``last_logits`` holds that prefill's (1, vocab) f32 logits."""
        self._check_call(params, state)
        self._set_prefill_inputs(tokens, prompt_len, slot, max_new)
        first, self.last_logits = self._run(
            "prefill", lambda: self._prefill_body(params))
        return state, first[0]

    def _rung(self, k: Optional[int]) -> int:
        k = self.decode_k if k is None else int(k)
        if k not in self.ladder:
            # a foreign k would need a program the warmup never built
            raise ValueError(
                f"decode k={k} is not a warmed ladder rung {self.ladder}")
        return k

    @torch.no_grad()
    def decode(self, params, state: ServeState, k: Optional[int] = None
               ) -> Tuple[ServeState, torch.Tensor, torch.Tensor]:
        """One decode superstep: up to ``k`` (default ``decode_k``, a
        ladder rung) tokens for every active slot. Returns ``(state,
        tokens (k, slots), valid (k, slots))`` on the device — entries
        with ``valid=False`` are placeholders (-1). Copy the tokens to the
        host to fence (on the card they are the graph's outputs,
        overwritten by the next decode)."""
        k = self._rung(k)
        self._check_call(params, state)
        toks, valid = self._run(f"decode_k{k}",
                                lambda: self._decode_body(params, k))
        return state, toks, valid

    @torch.no_grad()
    def eager_prefill(self, params, state: ServeState, tokens,
                      prompt_len: int, slot: int, max_new: int
                      ) -> Tuple[ServeState, torch.Tensor]:
        """:meth:`prefill` with its body run eagerly instead of replayed:
        the reference a check holds the captured program to
        (``chip_smoke.py``), never a serving route."""
        self._check_call(params, state)
        self._set_prefill_inputs(tokens, prompt_len, slot, max_new)
        first, self.last_logits = self._prefill_body(params)
        return state, first[0]

    @torch.no_grad()
    def eager_decode(self, params, state: ServeState,
                     k: Optional[int] = None
                     ) -> Tuple[ServeState, torch.Tensor, torch.Tensor]:
        """:meth:`decode` with its body run eagerly (see
        :meth:`eager_prefill`)."""
        k = self._rung(k)
        self._check_call(params, state)
        return (state, *self._decode_body(params, k))

    # ---------------------------------------------------------- warmup

    @torch.no_grad()
    def warmup(self, params) -> None:
        """Build every program off the request clock and pin ``params``:
        on the card, each body once eagerly (``nvcc`` at first use, the
        modules loaded) and then its graph; on the CPU, a dummy prefill
        and one superstep per ladder rung. A second warmup runs the
        programs built by the first. Leaves the state reset. After this
        a whole serve run, ladder moves included, builds nothing
        (:meth:`assert_two_programs`)."""
        state = self.init_state()
        self._check_call(params, state)
        self._set_prefill_inputs(torch.zeros((1, self.prompt_pad)), 1, 0, 2)
        if self.device.type == "cuda" and not self._graphs:
            self._capture(params)
        else:                    # built already (or the CPU): run them
            for name, body in self._programs(params).items():
                self._run(name, body)
        self.init_state()

    def program_memory(self) -> Dict[str, Dict[str, int]]:
        """The programs' scratch for the memory ledger (the JAX engine's
        ``program_memory``): on the card, the graph pools the captures
        hold (the prefill's and the decode ladder's, resident together,
        measured as one), ``{"temp_bytes": ...}``; on the CPU, where no
        program reports its scratch, ``{}`` for each."""
        if self._graphs:
            return {"graph_pools": {"temp_bytes": self.graph_pool_bytes}}
        return {name: {} for name in self.prefill_traces
                + self.decode_traces}

    def compile_counts(self) -> Tuple[int, int]:
        """(prefill programs, decode programs) built so far."""
        return len(self.prefill_traces), len(self.decode_traces)

    def assert_two_programs(self) -> None:
        """The program pin: one prefill + one decode program PER LADDER
        RUNG for the whole run, warmup included."""
        p, d = self.compile_counts()
        want = (1, len(self.ladder))
        if (p, d) != want:
            raise AssertionError(
                f"serve engine built {p} prefill / {d} decode "
                f"program(s), expected {want[0]}/{want[1]} for ladder "
                f"{self.ladder}; the two-program contract is broken")

    def reset_kernel_launches(self) -> None:
        """Set :meth:`kernel_launches` to 0; the captures' records of
        their launches stay."""
        self._eager_launches = 0
        self._replays = dict.fromkeys(self._replays, 0)

    def kernel_launches(self) -> int:
        """Flash-forward kernel launches of this engine's programs: those
        of eager body runs plus, for each graph, its replays times the
        launches its capture recorded (a replay does not move the
        wrappers' counters)."""
        return self._eager_launches + sum(
            self._replays[name] * n
            for name, n in self._captured_launches.items())
