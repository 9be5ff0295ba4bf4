"""Fault injection at the card's, the storage's, the request path's and
the cluster's seams (a reduced copy of pilosa_tpu/fault.py, with its rule knobs and
spec syntax).

    mesh.stage          before a view is packed and staged on the card
                        (index, frame, view, slices): an out-of-memory
                        error drives the staging's evict-and-retry ladder
    device.exec         before each guarded kernel launch (sig, kind):
                        drives the launch's ladder, the host fold and the
                        plan quarantine; at the result (kind=
                        "count-result"), `perturb` shifts a served count,
                        which shadow verification must catch
    storage.fsync       before every WAL commit fsync (kind="commit",
                        path, pending) and before a snapshot's temp-file
                        fsync (kind="snapshot", path)
    storage.rename      before a snapshot's atomic rename (path)
    storage.import_apply  after a bulk import's in-memory apply, before
                        it is made durable (path)
    storage.corrupt     the bytes of a fragment file as read (path,
                        kind="snapshot" for the main file, "side-wal"
                        for a snapshot's side log, "scrub" for the
                        scrubber's read): `corrupt` flips bits in them
    handler.query       the server side of POST /index/{i}/query (host,
                        index, remote): a delay is a slow node, an
                        error a failing one
    sched.admit         query-scheduler admission (tenant): a delay
                        stalls admission like an overloaded scheduler;
                        an error (an AdmissionError instance) forces
                        sheds (429)
    client.do           before each attempt of an InternalClient call
                        (host, method, path, attempt): an error (a
                        ConnectionError, say) is a transport failure,
                        retried and counted by the host's breaker
    executor.fanout     before a remote leg goes out (node): an error
                        fails the leg, and a transient one re-splits its
                        slices onto the other replicas
    hints.replay        before each hint the drainer replays (target,
                        kind): an error stops that target's log there,
                        in order, for the next pass
    syncer.block        before anti-entropy pulls and merges one block
                        (index, frame, view, slice, block): an error
                        fails that fragment's sync for this pass
    watchdog.stall      inside every registered heartbeat's beat()
                        (subsystem): a delay wedges that loop
                        mid-iteration with its heartbeat stale, the hang
                        the liveness watchdog must detect; e.g.
                        `watchdog.stall:delay=2,subsystem=scrub`

Arm a rule programmatically::

    fault.arm("device.exec", error=fault.SimulatedResourceExhausted,
              times=2, kind="count")
    fault.arm("storage.fsync", delay=0.3, kind="snapshot")
    ...
    fault.reset()

or from the environment, which the server reads at start (load_env())::

    PILOSA_TORCH_FAULT="storage.fsync:kind=commit,after=10,error=SIGKILL;\
device.exec:kind=count-result,delta=5"
    PILOSA_TORCH_FAULT_SEED=0      # seeds the prob= and bits= draws

Knobs: `error=` (a class or an instance; in a spec a name of
ERROR_NAMES, where SIGKILL kills the process at the seam, as a power
cut would), `delay=` (seconds, or "300ms" / "2s" in a spec: a sleep at
the seam, before any error), `times=N` (fire at most N times),
`after=N` (let the first N matches through), `prob=P` (fire with
probability P, drawn from one RNG seeded by reset(seed=) or
PILOSA_TORCH_FAULT_SEED), and any other keyword must equal the seam's
context of that name. A rule with neither error, delay nor a data knob
raises SimulatedResourceExhausted. Data knobs act only at their own
seams: `bits=N` / `offset=K` / `xor=M` make `corrupt(name, data)`
return data with N seeded-random bits flipped, or the byte at K
(counted from the end when negative) XORed with M (default 0x01);
`delta=N` makes `perturb(name, value)` return value + N. A seam with
no rule armed costs one dict probe.

Every fired fault is counted in `STATS` and recorded in the bounded
`log()` ring, (seam, context) newest last; reset() empties the ring.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from collections import Counter, deque
from typing import Dict, List, Optional

import torch

from .config import parse_duration

SEAMS = ("mesh.stage", "device.exec", "storage.fsync", "storage.rename",
         "storage.import_apply", "storage.corrupt", "handler.query",
         "sched.admit", "watchdog.stall", "client.do", "executor.fanout",
         "hints.replay", "syncer.block")
FAULT_ENV = "PILOSA_TORCH_FAULT"
SEED_ENV = "PILOSA_TORCH_FAULT_SEED"


class SimulatedResourceExhausted(torch.cuda.OutOfMemoryError):
    """An injected out-of-memory error. It is a torch.cuda.OutOfMemoryError,
    so the serving layer's one classifier treats it as the card's own."""

    def __init__(self, msg: str = ""):
        super().__init__(msg or "fault-injected device out of memory")


class ProcessKill(Exception):
    """Constructing it kills this process with SIGKILL: armed at a
    storage seam, it is a power cut at that point of the durability
    protocol (buffered op records are lost, files stay as they are)."""

    def __init__(self, *args):
        os.kill(os.getpid(), signal.SIGKILL)
        super().__init__(*args)


# Error names a spec may give as error=Name.
ERROR_NAMES = {
    "ResourceExhausted": SimulatedResourceExhausted,
    "SIGKILL": ProcessKill,
}

# Fired faults by seam: "fault.<seam>" -> count. Survives reset().
STATS: Counter = Counter()


class Rule:
    """One armed fault; its counters change under the registry's lock."""

    __slots__ = ("point", "error", "delay", "times", "after", "prob",
                 "match", "bits", "offset", "xor", "delta", "fired", "seen")

    def __init__(self, point: str, error, delay: float, times: Optional[int],
                 after: int, prob: float, match: Dict[str, object],
                 bits: int, offset: Optional[int], xor: int,
                 delta: Optional[int]):
        self.point = point
        self.error = error
        self.delay = float(delay)
        self.times = times  # None: unbounded
        self.after = int(after)
        self.prob = float(prob)
        self.match = match
        self.bits = int(bits)
        self.offset = offset
        self.xor = int(xor)
        self.delta = delta
        self.fired = 0  # times it fired
        self.seen = 0   # times it matched, skipped ones included

    def data_rule(self) -> bool:
        """A corrupt / perturb rule: plain point() seams ignore it."""
        return self.bits > 0 or self.offset is not None \
            or self.delta is not None

    def make_error(self) -> BaseException:
        if isinstance(self.error, BaseException):
            return self.error
        return self.error(f"fault injected at {self.point}")


_mu = threading.Lock()
_rules: Dict[str, List[Rule]] = {}
_rand = random.Random(0)
_log: "deque[tuple]" = deque(maxlen=256)


def arm(point: str, *, error=None, delay: float = 0.0,
        times: Optional[int] = None, after: int = 0, prob: float = 1.0,
        bits: int = 0, offset: Optional[int] = None, xor: int = 0x01,
        delta: Optional[int] = None, **match) -> Rule:
    """Arm a rule at `point` (module docstring)."""
    if point not in SEAMS:
        raise ValueError(f"unknown fault seam {point!r}; seams: {SEAMS}")
    rule = Rule(point, error, delay, times, after, prob, match, bits,
                offset, xor, delta)
    if rule.error is None and rule.delay <= 0 and not rule.data_rule():
        rule.error = SimulatedResourceExhausted
    with _mu:
        _rules.setdefault(point, []).append(rule)
    return rule


def disarm(rule: Rule) -> None:
    with _mu:
        rules = _rules.get(rule.point, [])
        if rule in rules:
            rules.remove(rule)
        if not rules:
            _rules.pop(rule.point, None)


def reset(seed: Optional[int] = None) -> None:
    """Drop every rule and empty the log; with `seed`, reseed the prob=
    and bits= draws."""
    global _rand
    with _mu:
        _rules.clear()
        _log.clear()
        if seed is not None:
            _rand = random.Random(seed)


def log() -> List[tuple]:
    """The recent fired faults: (seam, context dict), newest last."""
    with _mu:
        return list(_log)


def _fires(rule: Rule, ctx: dict) -> bool:
    """Count a match of `rule` against `ctx` and say whether it fires
    (after=, times=, prob=). Call under _mu."""
    if any(str(ctx.get(k)) != str(v) for k, v in rule.match.items()):
        return False
    rule.seen += 1
    if rule.seen <= rule.after:
        return False
    if rule.times is not None and rule.fired >= rule.times:
        return False
    if rule.prob < 1.0 and _rand.random() >= rule.prob:
        return False
    rule.fired += 1
    STATS[f"fault.{rule.point}"] += 1
    _log.append((rule.point, dict(ctx)))
    return True


def point(name: str, **ctx) -> None:
    """The seam: sleeps the longest delay of the rules that fire, then
    raises the first one's error."""
    if not _rules.get(name):
        return
    err, delay = None, 0.0
    with _mu:
        for rule in _rules.get(name, ()):
            if rule.data_rule() or not _fires(rule, ctx):
                continue
            delay = max(delay, rule.delay)
            if rule.error is not None and err is None:
                err = rule
    if delay > 0:
        time.sleep(delay)
    if err is not None:
        raise err.make_error()


def corrupt(name: str, data: bytes, **ctx) -> bytes:
    """The bit-rot seam: `data` with the armed bits= / offset= rules
    applied (itself when none fires)."""
    if not _rules.get(name) or not data:
        return data
    buf = None
    with _mu:
        for rule in _rules.get(name, ()):
            if (rule.bits <= 0 and rule.offset is None) \
                    or not _fires(rule, ctx):
                continue
            if buf is None:
                buf = bytearray(data)
            if rule.offset is not None:
                buf[rule.offset % len(buf)] ^= (rule.xor & 0xFF) or 0x01
            for _ in range(rule.bits):
                pos = _rand.randrange(len(buf) * 8)
                buf[pos >> 3] ^= 1 << (pos & 7)
    return data if buf is None else bytes(buf)


def perturb(name: str, value, **ctx):
    """The result seam: `value` shifted by the armed delta= rules (a
    kernel that silently miscomputes)."""
    if not _rules.get(name):
        return value
    with _mu:
        for rule in _rules.get(name, ()):
            if rule.delta is not None and _fires(rule, ctx):
                value = value + rule.delta
    return value


def load_spec(spec: str) -> List[Rule]:
    """Arm the rules of a `seam:key=val,...;seam2:...` spec."""
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        pt, _, body = part.partition(":")
        kw: dict = {}
        for item in body.split(","):
            if not item.strip():
                continue
            k, _, v = item.partition("=")
            k, v = k.strip(), v.strip()
            if k == "error":
                if v not in ERROR_NAMES:
                    raise ValueError(f"unknown fault error {v!r} (want one "
                                     f"of {sorted(ERROR_NAMES)})")
                kw["error"] = ERROR_NAMES[v]
            elif k == "delay":
                kw["delay"] = parse_duration(v)
            elif k in ("times", "after"):
                kw[k] = int(v)
            elif k == "prob":
                kw["prob"] = float(v)
            elif k in ("bits", "offset", "xor", "delta"):
                kw[k] = int(v, 0)
            else:
                kw[k] = v
        rules.append(arm(pt.strip(), **kw))
    return rules


def load_env() -> List[Rule]:
    """Arm the rules of $PILOSA_TORCH_FAULT, after seeding the draws
    from $PILOSA_TORCH_FAULT_SEED when it is set."""
    global _rand
    seed = os.environ.get(SEED_ENV)
    if seed:
        with _mu:
            _rand = random.Random(int(seed))
    return load_spec(os.environ.get(FAULT_ENV, ""))


def fill_cache(device) -> list:
    """Tensors that take every free block of PyTorch's large-block cache
    on the card `device`, largest first (best fit takes each block
    whole), so that a large allocation must come from cudaMalloc, whose
    free memory (torch.cuda.mem_get_info) then says what it can have: the
    ground a ballast stands on when a real out-of-memory error is made
    on purpose. Hold the list for as long as the cache must stay full."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    torch.cuda.empty_cache()
    sizes = sorted((b["size"] for seg in torch.cuda.memory_snapshot()
                    if seg["segment_type"] == "large"
                    and seg["device"] == idx
                    for b in seg["blocks"] if b["state"] == "inactive"),
                   reverse=True)
    return [torch.empty(n, dtype=torch.uint8, device=device) for n in sizes]
