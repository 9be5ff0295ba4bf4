"""Fault injection at the card's two memory seams (a reduced copy of
pilosa_tpu/fault.py).

    mesh.stage   before a view is packed and staged on the card (index,
                 frame, view, slices): an armed out-of-memory error
                 drives the staging's evict-and-retry ladder
    device.exec  before each guarded kernel launch (sig, kind): drives
                 the launch's ladder, the host fold and the plan
                 quarantine

Arm a rule programmatically::

    fault.arm("device.exec", error=fault.SimulatedResourceExhausted,
              times=2, kind="count")
    ...
    fault.reset()

`times=N` fires at most N times, `prob=P` fires with probability P
drawn from one RNG seeded by `reset(seed=)`, and any other keyword must
equal the seam's context of that name. A seam with no rule armed costs
one dict probe.
"""

from __future__ import annotations

import random
import threading
from collections import Counter
from typing import Dict, List, Optional

import torch

SEAMS = ("mesh.stage", "device.exec")


class SimulatedResourceExhausted(torch.cuda.OutOfMemoryError):
    """An injected out-of-memory error. It is a torch.cuda.OutOfMemoryError,
    so the serving layer's one classifier treats it as the card's own."""

    def __init__(self, msg: str = ""):
        super().__init__(msg or "fault-injected device out of memory")


# Fired faults by seam: "fault.<seam>" -> count. Survives reset().
STATS: Counter = Counter()


class Rule:
    """One armed fault; its counters change under the registry's lock."""

    __slots__ = ("point", "error", "times", "prob", "match", "fired")

    def __init__(self, point: str, error, times: Optional[int],
                 prob: float, match: Dict[str, object]):
        self.point = point
        self.error = error
        self.times = times  # None: unbounded
        self.prob = float(prob)
        self.match = match
        self.fired = 0

    def make_error(self) -> BaseException:
        if isinstance(self.error, BaseException):
            return self.error
        return self.error(f"fault injected at {self.point}")


_mu = threading.Lock()
_rules: Dict[str, List[Rule]] = {}
_rand = random.Random(0)


def arm(point: str, *, error=SimulatedResourceExhausted,
        times: Optional[int] = None, prob: float = 1.0, **match) -> Rule:
    """Arm a rule at `point`: raise `error` (a class or an instance)."""
    if point not in SEAMS:
        raise ValueError(f"unknown fault seam {point!r}; seams: {SEAMS}")
    rule = Rule(point, error, times, prob, match)
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
    """Drop every rule; with `seed`, reseed the prob= draws."""
    global _rand
    with _mu:
        _rules.clear()
        if seed is not None:
            _rand = random.Random(seed)


def point(name: str, **ctx) -> None:
    """The seam: raises the first armed rule's error that fires."""
    if not _rules.get(name):
        return
    err = None
    with _mu:
        for rule in _rules.get(name, ()):
            if any(str(ctx.get(k)) != str(v) for k, v in rule.match.items()):
                continue
            if rule.times is not None and rule.fired >= rule.times:
                continue
            if rule.prob < 1.0 and _rand.random() >= rule.prob:
                continue
            rule.fired += 1
            STATS[f"fault.{name}"] += 1
            err = rule.make_error()
            break
    if err is not None:
        raise err


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
