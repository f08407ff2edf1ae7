"""The prefill/decode-split serving engines: one prefill program and one
decode program per ladder rung (plus, paged and speculating, one verify
program), captured as CUDA graphs on the card.

Counterpart of ``tpudist/serve/engine.py``, whose jitted programs
become CUDA graphs here. The dense :class:`ServeEngine`:

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

On a **serve mesh** (``mesh=``: ``ParallelConfig()``'s, data = the
processes, one card each, under ``tpudist_torch.parallel.distributed``'s
env contract) each rank holds the params whole and its span of the slots
(:func:`~tpudist_torch.serve.kvcache.slot_span`: ``[r S/N, (r+1) S/N)``,
or every slot where ``N`` does not divide them, as the JAX engine's
sanitised cache spec places them). Rank 0 drives the engine through the
same calls, with global slot ids; each call is broadcast over the host
gloo group as a small fixed-size command (warm-up, state reset, prefill
with its prompt, decode with its rung), which the other ranks run in
:meth:`ServeEngine.follow` on their own slots, so every rank captures and
replays the same programs in the same order. A prefill runs on the
slot's owner (every rank where the slots are replicated); a decode on
every rank; the first token and the ``(k, slots)`` tokens come back to
rank 0's host by a gather over the host group. The MoE's decode routes
the global slot batch: its router probabilities are all-gathered over
the slot group (NCCL on the card, inside the decode graph). The pin and
the launch counts hold per rank. A follower whose leader is gone (its
command broadcast fails) raises, naming the lost leader.

:class:`PagedServeEngine` keeps the same discipline over a paged KV pool
(:mod:`tpudist_torch.serve.kvcache`): its prefill scatters the scratch
into the slot's pages, its decode and verify programs attend through
``paged_hidden_states``, and the host allocator's page table, the
dispatch mask, the prefill's page row and the draft are copied into the
graphs' input buffers before each replay, never rebound. On a serve mesh
every rank holds every slot and runs every prefill, decode and verify;
rank 0's allocator is the only one, and each command carries what its
programs read of it (the prefill's page row and ``shared_len``, the
dispatch's table and mask, the verify's draft). The pool's rows are
replicated, or split over the ranks where the sanitised spec splits them
(:func:`~tpudist_torch.serve.kvcache.pool_span`), the attention's
partial softmaxes then all-gathered over the :class:`PoolGroup`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpudist_torch.config import ModelConfig
from tpudist_torch.engine import gather_dim
from tpudist_torch.models import get_model
from tpudist_torch.ops.cuda import flash_attention as fa
from tpudist_torch.serve import kvcache
from tpudist_torch.utils.platform import resolve_device


# the commands rank 0 broadcasts to a serve mesh's followers: a header of
# (op, eager, four ints), then the payload's fields at fixed offsets (the
# engine's _fields: a prompt's tokens; paged, the page row, the table, the
# dispatch mask and the draft), one fixed size for every command
_WARMUP, _INIT, _PREFILL, _DECODE, _VERIFY, _STOP = range(1, 7)
_HEAD = 6


class SlotGroup(NamedTuple):
    """The ranks a serve mesh splits the slot batch over, in global slot
    order: rank ``index`` of ``ways`` holds the ``index``-th equal
    chunk."""

    group: object
    ways: int
    index: int

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked along dim 0 in slot order (an
        all-gather over the group, NCCL on the card)."""
        return gather_dim(x, 0, self.ways, self.group)


class PoolGroup(NamedTuple):
    """The ranks a serve mesh splits a paged pool's rows over: rank
    ``index`` of ``ways`` holds ``rows`` rows from global row ``lo`` of
    the ``n_rows`` (``pages + 1``)."""

    group: object
    ways: int
    index: int
    lo: int
    rows: int
    n_rows: int

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` on a new leading dim in rank order (an
        all-gather over the group, NCCL on the card)."""
        return gather_dim(x[None], 0, self.ways, self.group)


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
    programs and never builds one. ``mesh``: a serve mesh (module
    docstring); ``n_chips`` is its card count, 1 without one.
    """

    paged = False          # the scheduler branches on this, not on type
    speculate_k = 0        # speculation is a paged-engine feature

    def __init__(self, model_cfg: ModelConfig, *, slots: int,
                 max_seq: int, prompt_pad: int, decode_k: int = 8,
                 layout: str = "st", dtype=torch.float32, device=None,
                 adapt_ladder: Optional[Sequence[int]] = None, mesh=None):
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
        self.spec = self._cache_spec()
        self._join_mesh(mesh)
        dev = self.device
        self._state = self._new_state()
        # the prefill's static inputs: the padded prompt, and (prompt_len,
        # slot, max_new) as device ints; and its one-slot scratch cache
        self._tokens = torch.zeros((1, self.prompt_pad), dtype=torch.int64,
                                   device=dev)
        self._args = torch.zeros((3,), dtype=torch.int64, device=dev)
        shape = (model_cfg.n_layers, 1, self.prompt_pad,
                 model_cfg.n_kv_heads, model_cfg.d_model // model_cfg.n_heads)
        self._scratch = {
            name: torch.zeros(shape, dtype=dtype, device=dev)
            for name in ("k", "v")}
        self._params: Optional[Tuple[int, ...]] = None
        self.prefill_traces: list = []   # captures (CPU: first calls)
        self.decode_traces: list = []
        self._graphs: Dict[str, "torch.cuda.CUDAGraph"] = {}
        self._outputs: Dict[str, tuple] = {}
        self._captured_launches: Dict[str, int] = {}
        self._replays: Dict[str, int] = {}
        self._eager_launches = 0
        self._eager_calls = False
        self.capture_s = 0.0             # warmup's capture wall time
        self.graph_pool_bytes = 0        # device memory the captures hold
        self.last_logits: Optional[torch.Tensor] = None
        self.local_prefills = 0          # admissions this rank prefilled

    # ----------------------------------------------------------- state

    def _cache_spec(self) -> kvcache.CacheSpec:
        return kvcache.CacheSpec.from_model(
            self.model_cfg, slots=self.slots, max_seq=self.max_seq,
            dtype=self.dtype, layout=self.layout)

    def _vectors(self) -> dict:
        """The state's per-slot vectors, zeroed on the engine's device."""
        dev, s = self.device, self._hi - self._lo
        return dict(
            lengths=torch.zeros((s,), dtype=torch.int32, device=dev),
            last_token=torch.zeros((s,), dtype=torch.int32, device=dev),
            active=torch.zeros((s,), dtype=torch.bool, device=dev),
            remaining=torch.zeros((s,), dtype=torch.int32, device=dev))

    def _new_state(self) -> ServeState:
        cache = kvcache.init_cache(self.spec, self.device, self.mesh,
                                   self._rank)
        return ServeState(cache_k=cache["k"], cache_v=cache["v"],
                          **self._vectors())

    def init_state(self) -> ServeState:
        """Reset the engine's state in place (empty slots, zeroed cache)
        and return it."""
        if self._state is None:
            raise RuntimeError("this serve engine was released")
        self._lead(_INIT)
        return self._zero_state()

    def _zero_state(self) -> ServeState:
        for t in self._state:
            t.zero_()
        return self._state

    def _check_call(self, params, state: ServeState) -> None:
        if self._state is None:
            raise RuntimeError("this serve engine was released")
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

    # ------------------------------------------------------ serve mesh

    def _join_mesh(self, mesh) -> None:
        """This rank's part of a serve mesh's slots (every slot without a
        mesh): its span ``[_lo, _hi)`` of the global slot ids, every
        rank's span, and, where the cache's spec splits the slots, the
        group the MoE routes the global slot batch over."""
        self.mesh, self._slot_kw = mesh, {}
        self._rank, self._lo, self._hi = 0, 0, self.slots
        self.n_chips = 1
        if mesh is None:
            return
        from tpudist_torch.parallel import distributed
        from tpudist_torch.parallel.mesh import mesh_devices, mesh_shape
        other = {a: n for a, n in mesh_shape(mesh).items()
                 if a not in ("data", "fsdp") and n > 1}
        if other:
            raise ValueError(
                f"a serve mesh splits the slots over data and fsdp; "
                f"axes {other} would need a sharded serving forward")
        self._host = distributed.host_group()
        if self._host is None:
            raise ValueError(
                "a serve mesh needs the process group that "
                "tpudist_torch.parallel.distributed.initialize joins")
        if self.device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(self.device)
        self._rank = dist.get_rank()
        self._world = dist.get_world_size()
        self.n_chips = mesh_devices(mesh).size
        self._place(mesh)

    def _place(self, mesh) -> None:
        """This rank's slots on the joined mesh, and the slot group where
        the cache's spec splits them."""
        from tpudist_torch.parallel.mesh import axes_group
        from tpudist_torch.parallel.sharding import spec_axes
        self._spans = [kvcache.slot_span(self.spec, mesh, r)
                       for r in range(self._world)]
        self._lo, self._hi = self._spans[self._rank]
        axes = spec_axes(kvcache.cache_spec_on(self.spec, mesh)[1])
        if axes:
            group = axes_group(mesh, ("data", "fsdp"))
            ways = self.slots // (self._hi - self._lo)
            index = dist.get_rank(group)
            if index * (self._hi - self._lo) != self._lo:
                raise ValueError(
                    f"rank {self._rank} holds slots [{self._lo}, "
                    f"{self._hi}) but is rank {index} of its batch group")
            self._slot_kw = {"slot_group": SlotGroup(group, ways, index)}

    @property
    def split(self) -> bool:
        """True when a serve mesh splits the slots over its ranks."""
        return bool(self._slot_kw)

    @property
    def span(self) -> Tuple[int, int]:
        """The global slot ids ``[lo, hi)`` this rank holds."""
        return self._lo, self._hi

    def card_kv_bytes(self) -> int:
        """This rank's KV cache bytes: its span's share of the cache."""
        return self.spec.bytes * (self._hi - self._lo) // self.slots

    def _fields(self) -> Dict[str, int]:
        """The command payload's fields and their sizes, in order."""
        return {"tokens": self.prompt_pad}

    def _new_command(self) -> torch.Tensor:
        return torch.zeros((_HEAD + sum(self._fields().values()),),
                           dtype=torch.int64)

    def _field(self, cmd: torch.Tensor, name: str) -> torch.Tensor:
        """Field ``name`` of a command's payload (a view)."""
        at = _HEAD
        for field, size in self._fields().items():
            if field == name:
                return cmd[at:at + size]
            at += size
        raise KeyError(name)

    def _lead(self, op: int, *ints: int, **fields) -> None:
        """Rank 0's side of a command on a serve mesh: ``op``, its ints
        and its payload ``fields`` (arrays, flattened into their places)
        broadcast over the host group, every rank then running it on its
        own slots. A no-op without a mesh."""
        if self.mesh is None:
            return
        if self._rank != 0:
            raise RuntimeError(
                f"rank {self._rank} serves rank 0's commands (follow())")
        cmd = self._new_command()
        cmd[:2 + len(ints)] = torch.tensor(
            [op, int(self._eager_calls), *ints], dtype=torch.int64)
        for name, value in fields.items():
            self._field(cmd, name).copy_(torch.as_tensor(
                np.asarray(value, np.int64).reshape(-1)))
        dist.broadcast(cmd, src=0, group=self._host)

    def _report(self, first: Optional[torch.Tensor] = None,
                toks: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None,
                emitted: Optional[torch.Tensor] = None):
        """Every rank's answer to a command, gathered on rank 0's host:
        a prefill's first token from the ranks that ran it, a decode's or
        a verify's ``(k, local slots)`` tokens and valid flags, and a
        verify's ``emitted``. Returns the rows on rank 0 (None elsewhere,
        and without a mesh)."""
        if self.mesh is None:
            return None
        local = self._hi - self._lo
        n = max(self.ladder[0], self.speculate_k) * local
        buf = torch.full((1 + 2 * n + local,), -1, dtype=torch.int64)
        if self._rank != 0:          # rank 0 reads its own from the card
            if first is not None:
                buf[0] = int(first)
            if toks is not None:
                m = toks.numel()
                buf[1:1 + m] = toks.reshape(-1).cpu()
                buf[1 + n:1 + n + m] = valid.reshape(-1).cpu()
            if emitted is not None:
                buf[1 + 2 * n:] = emitted.cpu()
        rows = ([torch.empty_like(buf) for _ in range(self._world)]
                if self._rank == 0 else None)
        dist.gather(buf, rows, dst=0, group=self._host)
        return rows

    def _owns(self, slot: int) -> bool:
        return self._lo <= slot < self._hi

    def _do_prefill(self, params, tokens, prompt_len: int, slot: int,
                    max_new: int) -> Optional[torch.Tensor]:
        """A prefill, on every rank of a serve mesh: the slot's owner
        (every rank, replicated) runs the program; rank 0 returns the
        first token, its own or the owner's."""
        first = None
        self.last_logits = None
        if self._owns(slot):
            self._set_prefill_inputs(tokens, prompt_len, slot, max_new)
            first, self.last_logits = self._run(
                "prefill", lambda: self._prefill_body(params))
            self.local_prefills += 1
        rows = self._report(first=first)
        if self._rank != 0:
            return None
        if first is not None:
            return first[0]
        owner = next(r for r, (lo, hi) in enumerate(self._spans)
                     if lo <= slot < hi)
        return rows[owner][0]

    def _do_decode(self, params, k: int):
        """A decode superstep, on every rank of a serve mesh: its program
        for rung ``k`` over its own slots; rank 0 returns the ``(k,
        slots)`` tokens and valid flags in global slot order (its own
        where no mesh splits the slots)."""
        toks, valid = self._run(f"decode_k{k}",
                                lambda: self._decode_body(params, k))
        rows = self._report(toks=toks, valid=valid)
        if self._rank != 0:
            return None
        if not self.split:
            return toks, valid
        n = self.ladder[0] * (self._hi - self._lo)
        out_t = torch.empty((k, self.slots), dtype=torch.int32)
        out_v = torch.empty((k, self.slots), dtype=torch.bool)
        out_t[:, self._lo:self._hi] = toks.cpu()
        out_v[:, self._lo:self._hi] = valid.cpu()
        for r, (lo, hi) in enumerate(self._spans):
            if r != 0:
                m = k * (hi - lo)
                out_t[:, lo:hi] = rows[r][1:1 + m].view(k, hi - lo)
                out_v[:, lo:hi] = rows[r][1 + n:1 + n + m].view(
                    k, hi - lo).bool()
        return out_t, out_v

    @torch.no_grad()
    def follow(self, params) -> None:
        """A rank other than 0 on a serve mesh: run rank 0's commands on
        this rank's slots (warm-up, state resets, prefills, decodes; the
        eager bodies where rank 0 asks for them) until its stop, then hold
        this rank's program pin. Raises on a command that fails: the
        caller leaves at once, so rank 0's next collective with it fails
        rather than waits."""
        if self.mesh is None or self._rank == 0:
            raise RuntimeError("follow() is a serve mesh follower's loop")
        cmd = self._new_command()
        while True:
            try:
                dist.broadcast(cmd, src=0, group=self._host)
            except RuntimeError as e:     # gloo: the peer closed
                raise RuntimeError(
                    f"serve mesh rank {self._rank} lost its leader (rank "
                    f"0): the command broadcast failed ({e!r})") from e
            op, eager, *ints = (int(v) for v in cmd[:_HEAD])
            if op == _STOP:
                break
            self._eager_calls = bool(eager)
            try:
                self._follow(params, op, ints, cmd)
            finally:
                self._eager_calls = False
        self.assert_two_programs()

    def _follow(self, params, op: int, ints, cmd: torch.Tensor) -> None:
        """Run one of rank 0's commands on this rank."""
        a, b, c, _ = ints
        if op == _WARMUP:
            self._check_call(params, self._state)
            self._warmup(params)
            self._report()
        elif op == _INIT:
            self._zero_state()
        elif op == _PREFILL:
            self._do_prefill(params, self._field(cmd, "tokens").clone(),
                             a, b, c)
        elif op == _DECODE:
            self._do_decode(params, a)
        else:
            raise ValueError(f"unknown serve command {op}")

    def stop_followers(self) -> None:
        """Rank 0: end the followers' :meth:`follow` loops (a no-op
        without a mesh)."""
        self._lead(_STOP)

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
        self._store_prefill(plen, slot)
        st = self._state
        rem = max_new - 1            # the prefill itself produced token 1
        active = (rem > 0) & (plen < self.max_seq)
        st.lengths.index_copy_(0, slot, plen.to(torch.int32))
        st.last_token.index_copy_(0, slot, first)
        st.active.index_copy_(0, slot, active)
        st.remaining.index_copy_(
            0, slot, torch.where(active, rem, 0).to(torch.int32))
        return first, logits

    def _store_prefill(self, plen: torch.Tensor,
                       slot: torch.Tensor) -> None:
        """The scratch's k/v into the slot's cache columns ``[0,
        prompt_pad)`` (positions past ``plen`` hold pad-token junk, which
        the decode mask never reads)."""
        st = self._state
        for name, full in (("k", st.cache_k), ("v", st.cache_v)):
            kvcache.to_canonical(full, self.layout)[
                :, :, :self.prompt_pad].index_copy_(1, slot,
                                                    self._scratch[name])

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
                dtype=self.dtype, kv_cache=cache, cur_index=pos,
                **self._slot_kw)
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
        self._write_vectors(lengths, last, act, rem)
        return out

    def _write_vectors(self, lengths, last, active, rem) -> None:
        st = self._state
        st.lengths.copy_(lengths)
        st.last_token.copy_(last)
        st.active.copy_(active)
        st.remaining.copy_(rem)

    def _eager(self, body: Callable[[], tuple]) -> tuple:
        n0 = fa.launches
        out = body()
        self._eager_launches += fa.launches - n0
        return out

    def _run(self, name: str, body: Callable[[], tuple]) -> tuple:
        """Program ``name``: its graph replayed on the card, its body run
        on the CPU (where each body's first call counts as its build), or
        run eagerly anywhere inside :meth:`_eagerly` (a check's
        reference)."""
        if self._eager_calls:
            return body()
        if self.device.type == "cuda":
            graph = self._graphs.get(name)
            if graph is None:
                raise RuntimeError(
                    f"serve program {name} is not captured: call "
                    f"warmup(params) first")
            graph.replay()
            self._replays[name] += 1
            return self._outputs[name]
        if name not in self._traces(name):
            self._note_build(name)
        return self._eager(body)

    def _traces(self, name: str) -> list:
        """The build record program ``name`` counts in."""
        return self.prefill_traces if name == "prefill" \
            else self.decode_traces

    def _note_build(self, name: str) -> None:
        self._traces(name).append(name)

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
        self._check_prefill(prompt_len, slot)
        self._tokens.copy_(torch.as_tensor(tokens, dtype=torch.int64)
                           .reshape(1, self.prompt_pad))
        self._args.copy_(torch.tensor([prompt_len, slot - self._lo,
                                       max_new], dtype=torch.int64))

    def _check_prefill(self, prompt_len: int, slot: int) -> None:
        if not 0 < prompt_len <= self.prompt_pad:
            raise ValueError(f"prompt_len {prompt_len} must be in (0, "
                             f"prompt_pad {self.prompt_pad}]")
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} out of range [0, {self.slots})")

    @torch.no_grad()
    def prefill(self, params, state: ServeState, tokens, prompt_len: int,
                slot: int, max_new: int) -> Tuple[ServeState, torch.Tensor]:
        """Admit one request into ``slot`` (a global slot id). ``tokens``
        is the padded (1, prompt_pad) prompt. Returns the state and the
        request's FIRST generated token as a scalar tensor (``int()`` it
        to fence; on the card it is the graph's output, overwritten by
        the next prefill). ``last_logits`` holds that prefill's (1, vocab)
        f32 logits when this rank ran it. On a serve mesh the slot's owner
        runs it (every rank where the slots are replicated) and the token
        comes back to rank 0 over the host group."""
        self._check_call(params, state)
        self._check_prefill(prompt_len, slot)
        tokens = torch.as_tensor(tokens, dtype=torch.int64).reshape(
            self.prompt_pad)
        self._lead(_PREFILL, prompt_len, slot, max_new, tokens=tokens)
        return state, self._do_prefill(params, tokens, prompt_len, slot,
                                       max_new)

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
        self._lead(_DECODE, k)
        return (state, *self._do_decode(params, k))

    @contextlib.contextmanager
    def _eagerly(self):
        self._eager_calls = True
        try:
            yield
        finally:
            self._eager_calls = False

    def eager_prefill(self, *args, **kw):
        """:meth:`prefill` with its body run eagerly instead of replayed:
        the reference a check holds the captured program to
        (``chip_smoke.py``), never a serving route."""
        with self._eagerly():
            return self.prefill(*args, **kw)

    def eager_decode(self, *args, **kw):
        """:meth:`decode` with its body run eagerly (see
        :meth:`eager_prefill`)."""
        with self._eagerly():
            return self.decode(*args, **kw)

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
        if self._state is None:
            raise RuntimeError("this serve engine was released")
        self._check_call(params, self._state)
        self._lead(_WARMUP)
        self._warmup(params)
        self._report()

    def _warmup(self, params) -> None:
        self._zero_state()
        self._set_warmup_inputs()
        if self.device.type == "cuda" and not self._graphs:
            self._capture(params)
        else:                    # built already (or the CPU): run them
            for name, body in self._programs(params).items():
                self._run(name, body)
        self._zero_state()

    def _set_warmup_inputs(self) -> None:
        """Junk inputs for the warm-up calls: a one-token prompt into
        this rank's first slot with a budget of 2."""
        self._set_prefill_inputs(torch.zeros((1, self.prompt_pad)), 1,
                                 self._lo, 2)

    def program_memory(self) -> Dict[str, Dict[str, int]]:
        """The programs' scratch for the memory ledger (the JAX engine's
        ``program_memory``): on the card, the graph pools the captures
        hold (the prefill's and the decode ladder's, resident together,
        measured as one), ``{"temp_bytes": ...}``; on the CPU, where no
        program reports its scratch, ``{}`` for each."""
        if self._graphs:
            return {"graph_pools": {"temp_bytes": self.graph_pool_bytes}}
        return {name: {} for name in self._programs_built()}

    def _programs_built(self) -> list:
        return self.prefill_traces + self.decode_traces

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

    def release(self) -> None:
        """Drop the graphs (their pools with them), their outputs, the
        state (the KV cache) and the prefill's scratch, so the caching
        allocator holds them no more (``torch.cuda.empty_cache`` hands
        them back to the card; the serve tuner does so between trials).
        The graphs go first, before the memory they replay into. The
        record of captures and replays stays (:meth:`kernel_launches`);
        the engine serves no more."""
        self._graphs.clear()
        self._outputs.clear()
        self._state = None
        self._scratch = {}
        self.last_logits = None

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


class PagedServeState(NamedTuple):
    """Device-resident PAGED serving state, owned by the engine. K/V live
    in one shared pool of fixed-size pages (+1 trash page); the
    slot→page mapping is HOST state (``PageAllocator.table``), copied
    into each dispatch's input buffer."""

    pool_k: torch.Tensor        # (L, pages+1, page_tokens, kv, head_dim)
    pool_v: torch.Tensor
    lengths: torch.Tensor       # (slots,) int32: tokens in cache per slot
    last_token: torch.Tensor    # (slots,) int32: newest token, not cached
    active: torch.Tensor        # (slots,) bool: slot holds a live sequence
    remaining: torch.Tensor     # (slots,) int32: generation budget left


class PagedServeEngine(ServeEngine):
    """The paged + shared-prefix + speculative serving engine
    (``tpudist/serve/engine.py::PagedServeEngine``).

    The dense engine's program discipline, one prefill program and one
    decode program per ladder rung, plus one more when speculation is
    on: the VERIFY forward, one batched forward over a
    ``speculate_k``-token window per slot that scores a whole host draft
    at once. On the card each is a CUDA graph; the page table, the
    dispatch's slot mask, the prefill's page row and ``shared_len`` and
    the draft are copied into the graphs' input buffers before a replay.
    Admission, eviction, page exhaustion and drafting are host decisions
    between dispatches.

    ``speculate_k`` is the verify WINDOW: the slot's pending
    ``last_token`` plus ``speculate_k - 1`` draft tokens, so
    ``speculate_k >= 2`` turns speculation on and ``0`` leaves it off.
    Greedy output equals non-speculative greedy decode: every emitted
    token is the argmax after a verified token, and rejected drafts' junk
    K/V sits past the new length, where write-then-attend overwrites it
    before any query reaches it.

    Where the JAX decode skips a step with no active slot (``lax.cond``),
    every step runs here and the masks freeze the batch; slots outside a
    dispatch's mask keep their ``active`` untouched.

    ``mesh``: a serve mesh (module docstring). Every rank holds every
    slot, as the JAX paged state's replicated vectors, and the pool
    whole or, where the sanitised spec splits its rows, its chunk of them
    (``pool_group``); ``pool_ways`` is the ranks a page is spread over.
    """

    paged = True

    def __init__(self, model_cfg: ModelConfig, *, slots: int,
                 max_seq: int, prompt_pad: int, decode_k: int = 8,
                 page_tokens: int = 8, pages: int = 0,
                 speculate_k: int = 0, dtype=torch.float32, device=None,
                 adapt_ladder: Optional[Sequence[int]] = None, mesh=None):
        if speculate_k == 1 or speculate_k < 0:
            raise ValueError(
                f"--speculate-k must be 0 (off) or >= 2 (window of "
                f"last_token + drafts), got {speculate_k}")
        self.speculate_k = int(speculate_k)
        self._pages_kw = dict(page_tokens=page_tokens, pages=pages)
        super().__init__(model_cfg, slots=slots, max_seq=max_seq,
                         prompt_pad=prompt_pad, decode_k=decode_k,
                         layout="st", dtype=dtype, device=device,
                         adapt_ladder=adapt_ladder, mesh=mesh)
        self.page_tokens = self.spec.page_tokens
        self.alloc = kvcache.PageAllocator(self.spec)
        self.verify_traces: list = []
        dev, s = self.device, self.slots
        maxp = self.spec.max_pages_per_slot
        # the programs' per-dispatch inputs, copied in before each call
        self._page_row = torch.full((maxp,), -1, dtype=torch.int64,
                                    device=dev)
        self._shared_len = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._table = torch.full((s, maxp), -1, dtype=torch.int64,
                                 device=dev)
        self._dispatch = torch.ones((s,), dtype=torch.bool, device=dev)
        self._draft = torch.zeros((s, max(self.speculate_k - 1, 0)),
                                  dtype=torch.int64, device=dev)

    def _cache_spec(self) -> kvcache.PagedCacheSpec:
        return kvcache.PagedCacheSpec.from_model(
            self.model_cfg, slots=self.slots, max_seq=self.max_seq,
            dtype=self.dtype, **self._pages_kw)

    def _join_mesh(self, mesh) -> None:
        self.pool_group: Optional[PoolGroup] = None
        super()._join_mesh(mesh)

    def _place(self, mesh) -> None:
        """Every slot on every rank; this rank's rows of the pool, and
        the pool group where the sanitised spec splits them over several
        ranks."""
        from tpudist_torch.parallel.mesh import axes_group
        self._spans = [(0, self.slots)] * self._world
        n_rows = self.spec.pages + 1
        lo, hi = kvcache.pool_span(self.spec, mesh, self._rank)
        if hi - lo == n_rows:
            return
        group = axes_group(mesh, ("data", "fsdp"))
        index = dist.get_rank(group)
        if index * (hi - lo) != lo:
            raise ValueError(
                f"rank {self._rank} holds pool rows [{lo}, {hi}) but is "
                f"rank {index} of its batch group")
        self.pool_group = PoolGroup(group, n_rows // (hi - lo), index, lo,
                                    hi - lo, n_rows)

    @property
    def pool_ways(self) -> int:
        """The ranks each page's share of the pool is spread over (1:
        the pool is whole on every rank)."""
        return 1 if self.pool_group is None else self.pool_group.ways

    def card_kv_bytes(self) -> int:
        """This rank's pool bytes: the whole pool, or its chunk of the
        rows plus its discard row, beside the page table."""
        if self.pool_group is None:
            return self.spec.bytes
        row = (self.spec.bytes - self.spec.table_bytes) \
            // (self.spec.pages + 1)
        return row * (self.pool_group.rows + 1) + self.spec.table_bytes

    def _new_state(self) -> PagedServeState:
        pool = kvcache.init_paged_cache(
            self.spec, self.device,
            rows=0 if self.pool_group is None else self.pool_group.rows)
        return PagedServeState(pool_k=pool["k"], pool_v=pool["v"],
                               **self._vectors())

    def _fields(self) -> Dict[str, int]:
        maxp, s = self.spec.max_pages_per_slot, self.slots
        return {**super()._fields(), "row": maxp, "table": s * maxp,
                "mask": s, "draft": s * max(self.speculate_k - 1, 0)}

    def new_allocator(self) -> kvcache.PageAllocator:
        """Fresh page bookkeeping (drops any shared-prefix registry), one
        allocator per serve run, like one state per run. The memory bound
        the previous allocator was given (``set_memory_bound``) carries
        over: it is a property of the device, not of the run."""
        old = self.alloc
        self.alloc = kvcache.PageAllocator(self.spec)
        self.alloc.page_cap = old.page_cap
        self.alloc.bound_source = old.bound_source
        return self.alloc

    # -------------------------------------------------------- programs

    def _store_prefill(self, plen: torch.Tensor,
                       slot: torch.Tensor) -> None:
        """Scatter the scratch's true positions into the slot's pages.
        Positions below ``shared_len`` are skipped (their pages are the
        shared prefix, holding the same content); they and the padded
        tail go to the trash page."""
        pt = self.spec.page_tokens
        t = torch.arange(self.prompt_pad, device=self.device)
        write = (t >= self._shared_len) & (t < plen)
        pg = self._page_row[t // pt]
        pg = self._own_rows(torch.where(write & (pg >= 0), pg,
                                        self.spec.pages))
        off = t % pt
        st = self._state
        st.pool_k[:, pg, off] = self._scratch["k"][:, 0]
        st.pool_v[:, pg, off] = self._scratch["v"][:, 0]

    def _own_rows(self, pg: torch.Tensor) -> torch.Tensor:
        """Global pool rows -> this rank's: on a split pool a row another
        rank holds goes to the discard row."""
        g = self.pool_group
        if g is None:
            return pg
        pg = pg - g.lo
        return torch.where((pg >= 0) & (pg < g.rows), pg, g.rows)

    def _paged_forward(self, params, tokens, positions, write_ok
                       ) -> torch.Tensor:
        """Tied logits (slots, window, vocab) f32 of one windowed forward
        against the pool, its k/v written in place."""
        st = self._state
        h, _, _ = self.model.paged_hidden_states(
            params, tokens, self.model_cfg, dtype=self.dtype,
            pool_k=st.pool_k, pool_v=st.pool_v, page_table=self._table,
            positions=positions, write_ok=write_ok,
            page_tokens=self.spec.page_tokens, pool_group=self.pool_group)
        return self._tied_logits(params, h)

    def _decode_body(self, params, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The paged decode program for rung ``k``: ``k`` masked window-1
        steps over the slots in the dispatch mask; returns (tokens (k,
        slots) int32, valid (k, slots)) and writes the state."""
        st, da = self._state, self._dispatch
        lengths, last, active, rem = (st.lengths, st.last_token,
                                      st.active, st.remaining)
        toks, valid = [], []
        for _ in range(k):
            act = active & da
            pos = lengths.clamp(max=self.max_seq - 1).to(torch.int64)
            logits = self._paged_forward(
                params, last[:, None].to(torch.int64), pos[:, None],
                (act & (lengths < self.max_seq))[:, None])
            nxt = logits[:, 0].argmax(dim=-1).to(torch.int32)
            new_len = torch.where(act, lengths + 1, lengths)
            new_rem = torch.where(act, rem - 1, rem)
            toks.append(torch.where(act, nxt, -1))
            valid.append(act)
            last = torch.where(act, nxt, last)
            # slots OUTSIDE this dispatch (their page rows may be stale)
            # keep their activity untouched
            active = torch.where(
                da, act & (new_rem > 0) & (new_len < self.max_seq), active)
            lengths, rem = new_len, new_rem
        out = torch.stack(toks), torch.stack(valid)
        self._write_vectors(lengths, last, active, rem)
        return out

    def _verify_body(self, params
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The verify program: one forward over each dispatched slot's
        window (``last_token`` + the draft); the accepted run is the
        draft's prefix that matches the greedy choices, plus one bonus
        token, clamped to the budget and the capacity. Returns (tokens
        (W, slots) int32, valid (W, slots), emitted (slots,) int32) and
        writes the state."""
        st, da = self._state, self._dispatch
        w, dev = self.speculate_k, self.device
        act = st.active & da
        lengths = st.lengths.to(torch.int64)
        rem = st.remaining.to(torch.int64)
        toks_in = torch.cat([st.last_token[:, None].to(torch.int64),
                             self._draft], dim=1)                # (S, W)
        offs = torch.arange(w, device=dev)[None, :]
        raw_pos = lengths[:, None] + offs
        logits = self._paged_forward(
            params, toks_in, raw_pos.clamp(max=self.max_seq - 1),
            act[:, None] & (raw_pos < self.max_seq))
        g = logits.argmax(dim=-1)                                # (S, W)
        # draft token j is accepted iff it and every earlier one matched
        match = (self._draft == g[:, :-1]).to(torch.int64)
        a = torch.cumprod(match, dim=1).sum(dim=1)               # (S,)
        e = torch.minimum(a + 1, torch.minimum(rem,
                                               self.max_seq - lengths))
        e = torch.where(act, e, 0)
        valid = act[:, None] & (offs < e[:, None])               # (S, W)
        toks = torch.where(valid, g, -1).to(torch.int32)
        new_last = torch.gather(g, 1, (e - 1).clamp(min=0)[:, None])[:, 0]
        new_len = torch.where(act, lengths + e, lengths)
        new_rem = torch.where(act, rem - e, rem)
        new_active = torch.where(
            da, act & (new_rem > 0) & (new_len < self.max_seq), st.active)
        out = toks.T, valid.T, e.to(torch.int32)
        self._write_vectors(
            new_len, torch.where(act, new_last.to(torch.int32),
                                 st.last_token), new_active, new_rem)
        return out

    def _programs(self, params) -> Dict[str, Callable[[], tuple]]:
        progs = super()._programs(params)
        if self.speculate_k >= 2:
            progs["verify"] = lambda: self._verify_body(params)
        return progs

    def _traces(self, name: str) -> list:
        if name == "verify":
            return self.verify_traces
        return super()._traces(name)

    def _programs_built(self) -> list:
        return super()._programs_built() + self.verify_traces

    # ------------------------------------------------------ public API

    def _set_page_inputs(self, page_row, shared_len: int) -> None:
        self._page_row.copy_(torch.as_tensor(np.asarray(
            page_row, np.int64).reshape(self.spec.max_pages_per_slot)))
        self._shared_len.fill_(int(shared_len))

    def _dispatch_inputs(self, dispatch_active):
        """The allocator's table and the dispatch mask (default: every
        slot), as host arrays."""
        mask = (np.ones((self.slots,), bool) if dispatch_active is None
                else np.asarray(dispatch_active, bool).reshape(self.slots))
        return np.asarray(self.alloc.table, np.int64), mask

    def _set_dispatch_inputs(self, table, mask) -> None:
        self._table.copy_(torch.as_tensor(np.asarray(table, np.int64))
                          .reshape(self._table.shape))
        self._dispatch.copy_(torch.as_tensor(np.asarray(mask, bool))
                             .reshape(self.slots))

    def _follow(self, params, op: int, ints, cmd: torch.Tensor) -> None:
        """The dense commands, each paged one first copying what it
        carries of rank 0's allocator into the programs' input buffers,
        and the verify."""
        if op == _PREFILL:
            self._set_page_inputs(self._field(cmd, "row"), ints[3])
        elif op in (_DECODE, _VERIFY):
            self._set_dispatch_inputs(self._field(cmd, "table"),
                                      self._field(cmd, "mask"))
        if op == _VERIFY:
            self._draft.copy_(self._field(cmd, "draft").view(
                self._draft.shape))
            self._do_verify(params)
        else:
            super()._follow(params, op, ints, cmd)

    @torch.no_grad()
    def prefill(self, params, state: PagedServeState, tokens,
                prompt_len: int, slot: int, max_new: int, page_row=None,
                shared_len: int = 0
                ) -> Tuple[PagedServeState, torch.Tensor]:
        """Admit one request into ``slot``: the dense contract plus the
        slot's page-table ROW (default: the allocator's current row for
        ``slot``) and the shared-prefix watermark ``shared_len``
        (``alloc.admit_shared_len``), both inputs of the one program. On
        a serve mesh the command carries both; every rank runs it."""
        self._check_call(params, state)
        self._check_prefill(prompt_len, slot)
        tokens = torch.as_tensor(tokens, dtype=torch.int64).reshape(
            self.prompt_pad)
        row = self.alloc.row(slot) if page_row is None else page_row
        self._lead(_PREFILL, prompt_len, slot, max_new, int(shared_len),
                   tokens=tokens, row=row)
        self._set_page_inputs(row, shared_len)
        return state, self._do_prefill(params, tokens, prompt_len, slot,
                                       max_new)

    def register_prefix(self, params, state: PagedServeState,
                        prefix_tokens, prefix_len: int
                        ) -> PagedServeState:
        """Cache a shared system-prompt prefix ONCE for every later
        admission: reserve its full pages (registry-held, refcounted) and
        fill them with the ONE prefill program (``max_new=1``, so the
        probe slot comes back inactive and a real admission overwrites
        its entries). Causal masking makes the stored K/V what any prompt
        starting with the prefix computes there. The partial tail page
        goes to the trash page; admissions recompute it into their first
        private page (the copy-on-write fork). On a serve mesh rank 0's
        allocator reserves the pages and the prefill command carries
        them as its page row, so every rank fills them."""
        pages = self.alloc.register_shared(prefix_len)
        if not pages:
            return state
        row = np.full((self.spec.max_pages_per_slot,), -1, np.int64)
        row[:len(pages)] = pages
        padded = np.zeros((self.prompt_pad,), np.int64)
        padded[:prefix_len] = np.asarray(prefix_tokens)[:prefix_len]
        state, first = self.prefill(params, state, padded, prefix_len, 0,
                                    1, page_row=row, shared_len=0)
        int(first)                         # fence
        return state

    @torch.no_grad()
    def decode(self, params, state: PagedServeState,
               k: Optional[int] = None, dispatch_active=None
               ) -> Tuple[PagedServeState, torch.Tensor, torch.Tensor]:
        """One paged decode superstep over the slots in
        ``dispatch_active`` (default: all), with the allocator's current
        table. Returns ``(state, tokens (k, slots), valid (k, slots))``
        as :meth:`ServeEngine.decode` does."""
        k = self._rung(k)
        self._check_call(params, state)
        table, mask = self._dispatch_inputs(dispatch_active)
        self._lead(_DECODE, k, table=table, mask=mask)
        self._set_dispatch_inputs(table, mask)
        return (state, *self._do_decode(params, k))

    @torch.no_grad()
    def verify(self, params, state: PagedServeState, draft,
               dispatch_active=None):
        """Score a ``(slots, speculate_k - 1)`` host draft in ONE batched
        forward. Returns ``(state, tokens (speculate_k, slots), valid
        (speculate_k, slots), emitted (slots,))``, the tokens and valid
        flags oriented as :meth:`decode`'s; ``emitted`` counts each
        slot's accepted run + bonus token."""
        if self.speculate_k < 2:
            raise ValueError("verify() requires speculate_k >= 2")
        self._check_call(params, state)
        draft = np.asarray(draft, np.int64).reshape(self._draft.shape)
        table, mask = self._dispatch_inputs(dispatch_active)
        self._lead(_VERIFY, table=table, mask=mask, draft=draft)
        self._set_dispatch_inputs(table, mask)
        self._draft.copy_(torch.as_tensor(draft))
        return (state, *self._do_verify(params))

    def _do_verify(self, params):
        """A verify, on every rank of a serve mesh; rank 0 returns its
        (tokens, valid, emitted), the followers' reported beside."""
        toks, valid, e = self._run("verify",
                                   lambda: self._verify_body(params))
        self._report(toks=toks, valid=valid, emitted=e)
        return None if self._rank != 0 else (toks, valid, e)

    def eager_verify(self, *args, **kw):
        """:meth:`verify` with its body run eagerly (see
        :meth:`ServeEngine.eager_prefill`)."""
        with self._eagerly():
            return self.verify(*args, **kw)

    def _set_warmup_inputs(self) -> None:
        """Junk inputs: the dense warm-up's prompt, an all -1 page row
        and table (every write lands on the trash page), every slot in
        the dispatch, a zero draft."""
        super()._set_warmup_inputs()
        self._page_row.fill_(-1)
        self._shared_len.zero_()
        self._table.fill_(-1)
        self._dispatch.fill_(True)
        self._draft.zero_()

    def assert_two_programs(self) -> None:
        """The dense pin (1 prefill + 1 decode per rung) plus exactly one
        verify program when speculation is on."""
        super().assert_two_programs()
        want = 1 if self.speculate_k >= 2 else 0
        v = len(self.verify_traces)
        if v != want:
            raise AssertionError(
                f"paged serve engine built {v} verify program(s), "
                f"expected {want} (speculate_k={self.speculate_k}); the "
                f"program-budget pin is broken")
