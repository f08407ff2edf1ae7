"""The fault schedule: a seeded, deterministic chaos plan. A copy of
``tpudist/chaos/plan.py`` (standard library only; ``tests/
test_torch_serve_chaos.py`` holds it to its source).

A chaos plan is a list of scripted fault events, each pinned to an
``(epoch, step[, rank])`` trigger point, parsed from ``--chaos``/
``TPUDIST_CHAOS``::

    kill@0:5 ; corrupt_shard@0:6,mode=flip ; fs_error@0:3,n=2

Grammar (whitespace around separators is ignored)::

    SPEC  := EVENT (";" EVENT)*
    EVENT := KIND "@" EPOCH ":" STEP [":" RANK] ("," KEY "=" VAL)*

The seven fault families and their knobs:

  * ``kill``              — hard preemption: ``os._exit`` at the step
    boundary, no ``finally`` blocks, no drain (``rc``, default 113 —
    the same contract as ``TPUDIST_TEST_KILL``);
  * ``hang``              — wedge the step loop without progress notes
    until the flight-recorder watchdog dumps, then die un-orderly
    (``rc`` default 137 = ``timeout -k``'s SIGKILL after the grace
    window; ``max_s`` bounds the wedge when no watchdog is armed);
  * ``slow``              — straggler: sleep ``s`` seconds per step for
    ``steps`` consecutive steps on the matching rank;
  * ``corrupt_shard``     — flip (``mode=flip``) or truncate
    (``mode=truncate``) the just-written checkpoint shard file AFTER
    it landed — the commit proceeds, restore must detect it by crc;
  * ``torn_manifest``     — die between the shard index landing and the
    manifest commit (``rc`` default 113);
  * ``fs_error``          — raise a transient filesystem error
    (``errno`` = ``EIO``|``ENOSPC``) from the first ``n`` shard-write
    attempts of the matching save;
  * ``telemetry_garbage`` — inject ``n`` seeded garbage bytes into the
    live-telemetry stream mid-run.

Plus the three serve-surface families (:data:`SERVE_KINDS` —
``serve_kill`` / ``serve_slow`` / ``request_garbage``), fired into the
serving loop's dispatch boundaries and arrival stream instead
(:meth:`tpudist_torch.chaos.inject.ChaosRuntime.on_serve_dispatch`).

Rank ``-1`` (the default) matches every rank. Triggers use ``step >=``
semantics like ``TPUDIST_TEST_KILL`` (superstep dispatch may cross the
exact step); every event fires exactly once — the checkpoint-path
events bind to the first matching save. Determinism is the whole point:
the same spec + seed replays the same faults byte-for-byte
(:func:`garbage_bytes`, the corrupt-shard byte flips), so the invariant
checker (the JAX package's ``tpudist.chaos.verify``) can pin exact
outcomes.

Stdlib-only by design: the drill and the verifier import this on
CI hosts with no accelerator stack.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

FAULT_KINDS = ("kill", "hang", "slow", "corrupt_shard", "torn_manifest",
               "fs_error", "telemetry_garbage")

# The serve-surface families: the same grammar, fired into the
# serving loop instead of the train loop. The trigger's coordinates
# reinterpret as (epoch=0, step=decode-dispatch index):
#
#   * ``serve_kill``      — hard preemption at a decode-dispatch
#     boundary (``rc``, default 137 — the preemption reaper's SIGKILL
#     code, so the jax-free requeue policy classifies it without the
#     train lane's beacon machinery);
#   * ``serve_slow``      — per-decode-dispatch stall: ``s`` seconds on
#     each of ``steps`` consecutive dispatches (a straggler chip / a
#     noisy neighbor on the serving pod);
#   * ``request_garbage`` — ``n`` seeded MALFORMED requests injected
#     into the arrival stream (out-of-range tokens, dead budgets, wrong
#     shapes/dtypes — tpudist_torch.serve.scheduler.make_garbage_requests);
#     admission must reject every one, the engine must never see them.
SERVE_KINDS = frozenset({"serve_kill", "serve_slow", "request_garbage"})
ALL_KINDS = FAULT_KINDS + tuple(sorted(SERVE_KINDS))

# Events that fire at train-step boundaries vs inside the checkpoint
# write path (the two injection surfaces the train runtime wires).
STEP_KINDS = frozenset({"kill", "hang", "slow", "telemetry_garbage"})
CKPT_KINDS = frozenset({"corrupt_shard", "torn_manifest", "fs_error"})


@dataclass(frozen=True)
class FaultEvent:
    """One scripted fault: what, where, and its knobs."""

    kind: str
    epoch: int
    step: int
    rank: int = -1                       # -1 = every rank
    args: Dict[str, Any] = field(default_factory=dict)
    index: int = 0                       # position in the spec (seeding)

    def matches(self, epoch: int, step: int, rank: int) -> bool:
        return (epoch == self.epoch and step >= self.step
                and (self.rank < 0 or self.rank == rank))

    def describe(self) -> str:
        where = f"{self.epoch}:{self.step}"
        if self.rank >= 0:
            where += f":{self.rank}"
        extra = ",".join(f"{k}={v}" for k, v in sorted(self.args.items()))
        return f"{self.kind}@{where}" + (f",{extra}" if extra else "")


def _parse_val(raw: str) -> Any:
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        return raw


def _parse_event(part: str, index: int) -> FaultEvent:
    head, _, tail = part.partition(",")
    kind, sep, where = head.partition("@")
    kind = kind.strip()
    if not sep or kind not in ALL_KINDS:
        raise ValueError(
            f"chaos event {part!r}: expected <fault>@<epoch>:<step>"
            f"[:<rank>][,k=v...] with fault one of {ALL_KINDS}")
    coords = where.strip().split(":")
    if len(coords) not in (2, 3):
        raise ValueError(
            f"chaos event {part!r}: trigger must be <epoch>:<step> or "
            f"<epoch>:<step>:<rank>")
    try:
        epoch, step = int(coords[0]), int(coords[1])
        rank = int(coords[2]) if len(coords) == 3 else -1
    except ValueError:
        raise ValueError(
            f"chaos event {part!r}: epoch/step/rank must be integers")
    args: Dict[str, Any] = {}
    if tail.strip():
        for kv in tail.split(","):
            k, sep, v = kv.partition("=")
            if not sep or not k.strip():
                raise ValueError(
                    f"chaos event {part!r}: bad arg {kv!r} (want k=v)")
            args[k.strip()] = _parse_val(v.strip())
    return FaultEvent(kind=kind, epoch=epoch, step=step, rank=rank,
                      args=args, index=index)


@dataclass(frozen=True)
class ChaosPlan:
    """An immutable parsed fault schedule. Mutable firing state lives in
    the runtime (:class:`tpudist_torch.chaos.inject.ChaosRuntime`), so one
    plan object can drive a run and be re-read by the verifier."""

    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0

    @classmethod
    def parse(cls, spec: Optional[str], seed: int = 0) -> "ChaosPlan":
        events: List[FaultEvent] = []
        for i, part in enumerate(p.strip() for p in (spec or "").split(";")):
            if not part:
                continue
            events.append(_parse_event(part, len(events)))
        return cls(events=tuple(events), seed=int(seed))

    @property
    def step_events(self) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.kind in STEP_KINDS)

    @property
    def ckpt_events(self) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.kind in CKPT_KINDS)

    @property
    def serve_events(self) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.kind in SERVE_KINDS)

    def describe(self) -> str:
        return "; ".join(e.describe() for e in self.events) or "<empty>"


def garbage_bytes(plan: ChaosPlan, event: FaultEvent,
                  n: Optional[int] = None) -> bytes:
    """``n`` deterministic pseudo-random bytes for ``event`` — a sha256
    counter stream keyed by (plan seed, event index), so the same spec
    injects the same garbage every run and the decoder-resync drill is
    replayable."""
    if n is None:
        n = int(event.args.get("n", 64))
    out = b""
    counter = 0
    key = f"tpudist-chaos:{plan.seed}:{event.index}".encode()
    while len(out) < n:
        out += hashlib.sha256(key + counter.to_bytes(8, "big")).digest()
        counter += 1
    return out[:n]


def corrupt_positions(plan: ChaosPlan, event: FaultEvent, size: int,
                      flips: Optional[int] = None) -> List[int]:
    """Deterministic byte offsets for ``mode=flip`` shard corruption:
    seeded positions spread over the MIDDLE half of the file (an
    uncompressed npz keeps its zip headers at the edges — mid-file
    offsets land in array data, the bytes the shard crc covers)."""
    if flips is None:
        flips = int(event.args.get("flips", 8))
    lo, hi = size // 4, max(size // 4 + 1, (3 * size) // 4)
    raw = garbage_bytes(plan, event, n=8 * flips)
    out = []
    for i in range(flips):
        v = int.from_bytes(raw[8 * i:8 * i + 8], "big")
        out.append(lo + v % max(hi - lo, 1))
    return sorted(set(out))
