"""Deterministic fault injection (≙ ``blaze_tpu/runtime/faults.py``).

The recovery paths of the scheduler (``runtime/retry.py``,
``runtime/speculation.py``, the attempt loop in ``runtime/scheduler.py``
and the worker pool, ``runtime/hostpool.py``) are tested by failures
injected at named sites through :func:`hit`, on the task's own thread,
so that the hit numbers are the same run after run:

==================  ====================================================
site                probed where
==================  ====================================================
``task.compute``    ``serde.from_proto.run_task``, before the plan is built
``shuffle.write``   ``ShuffleRepartitioner.write_output`` (the map-side
                    commit; its ``@corrupt`` after the rename)
``shuffle.fetch``   ``IpcReaderExec``, once a block (raises
                    ``FetchFailedError``)
``broadcast.write`` ``IpcWriterExec`` (its ``@corrupt`` where the blob
                    is collected)
``worker.task``     ``runtime/worker.py``, at a job's start and at each
                    of its output batches, inside the worker process
``worker.result``   ``runtime/worker.py``, its ``@corrupt`` after a
                    result file is written
==================  ====================================================

:data:`SITES` keeps the reference's nine names, so that every spec it
parses parses here.  The other three fire nowhere yet: ``spill.write``
waits for the memory manager (ROADMAP A.9), ``kernel.dispatch`` for the
launch counters and the OOM ladder (A.7, A.9), ``rss.push`` for the
remote shuffle (A.11).

A spec maps each site to the 1-based hit numbers that fire, optionally
only for one task attempt id::

    spec     := entry ("," entry)*
    entry    := site "@" hit [ "@a" attempt ]
                [ "@slow" ms | "@oom" | "@corrupt" | "@enospc" | "@kill" ]
    example  := "shuffle.fetch@2,task.compute@1@a0,shuffle.write@3@corrupt"

A plain entry raises :class:`InjectedFault` (``FetchFailedError`` at
``shuffle.fetch``); ``@oom`` raises :class:`InjectedOom` and
``@enospc`` :class:`InjectedDiskFull` (both retried here: the port has
no OOM or disk ladder yet); ``@kill`` SIGKILLs the process, the hard
death the pool must recover from, armed only in a worker process
(:func:`mark_worker_process`) through its environment
(``BLAZE_FAULTS_SPEC``): a driver refuses it; ``@slow<ms>`` sleeps that
long and returns, a straggler for speculation and wedge detection.  A straggler whose
task is cancelled wakes at once (the probe is handed the task's cancel
event), where the reference sleeps it out.  ``@corrupt`` counts on its
own counter, the Nth committed block at the site, through
:func:`corrupt`: when it fires the site flips a committed byte, and the
reader's checksum must catch it.

Hit counters are per process.  The spec comes from
``spark.blaze.faults.spec`` (``BLAZE_FAULTS_SPEC`` overrides it) at the
first :func:`hit`, and again, counters reset, at :func:`reset`.  With
no spec :func:`hit` is one bool check.
"""

from __future__ import annotations

import errno
import os
import random
import signal
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from .. import conf

SITES = (
    "shuffle.write",
    "shuffle.fetch",
    "task.compute",
    "rss.push",
    "spill.write",
    "kernel.dispatch",
    "broadcast.write",
    "worker.result",
    "worker.task",
)


class InjectedFault(RuntimeError):
    """An injected failure at a named site (retried)."""

    def __init__(self, site: str, hit: int, detail: str = ""):
        self.site = site
        self.hit = hit
        super().__init__(f"injected fault at {site} (hit {hit})" + (f": {detail}" if detail else ""))


class InjectedOom(InjectedFault):
    """An injected device-memory exhaustion (``@oom``), with the
    reference's status string."""

    def __init__(self, site: str, hit: int, detail: str = ""):
        super().__init__(site, hit, detail)
        self.args = (f"RESOURCE_EXHAUSTED: injected device OOM at {site} (hit {hit})"
                     + (f": {detail}" if detail else ""),)


class InjectedDiskFull(OSError):
    """An injected ``ENOSPC`` (``@enospc``): a real ``OSError``."""

    def __init__(self, site: str, hit: int, detail: str = ""):
        super().__init__(errno.ENOSPC, f"injected ENOSPC at {site} (hit {hit})" + (f": {detail}" if detail else ""))
        self.site = site
        self.hit = hit


# (site, hit, attempt or None for any, slow ms or None, kind): kind
# False raises InjectedFault, True InjectedOom, or one of "corrupt",
# "enospc", "kill" (the reference's rule tuple)
Rule = Tuple[str, int, Optional[int], Optional[int], object]


def parse_spec(spec: str) -> List[Rule]:
    rules: List[Rule] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split("@")
        if len(parts) < 2:
            raise ValueError(f"bad fault spec entry {entry!r}")
        site, hit = parts[0], int(parts[1])
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} (known: {SITES})")
        attempt: Optional[int] = None
        slow_ms: Optional[int] = None
        kind: object = False
        for mod in parts[2:]:
            if mod in ("oom", "corrupt", "enospc", "kill"):
                if kind is not False:
                    raise ValueError(f"duplicate/conflicting kind modifier in {entry!r}")
                kind = True if mod == "oom" else mod
            elif mod.startswith("slow"):
                if slow_ms is not None:
                    raise ValueError(f"duplicate slow modifier in {entry!r}")
                slow_ms = int(mod[4:])
            elif mod.startswith("a"):
                if attempt is not None:
                    raise ValueError(f"duplicate attempt filter in {entry!r}")
                attempt = int(mod[1:])
            else:
                raise ValueError(f"bad modifier {mod!r} in {entry!r}")
        if kind is not False and slow_ms is not None:
            raise ValueError(f"kind and slow modifiers are exclusive in {entry!r}")
        rules.append((site, hit, attempt, slow_ms, kind))
    return rules


def format_spec(rules: List[Rule]) -> str:
    out = []
    for site, hit, attempt, slow_ms, kind in rules:
        s = f"{site}@{hit}"
        if attempt is not None:
            s += f"@a{attempt}"
        if slow_ms is not None:
            s += f"@slow{slow_ms}"
        if kind is True:
            s += "@oom"
        elif kind:
            s += f"@{kind}"
        out.append(s)
    return ",".join(out)


def random_spec(seed: int, n_faults: int = 3,
                sites: Tuple[str, ...] = ("shuffle.fetch", "task.compute", "shuffle.write"),
                horizon: int = 8, first_attempt_only: bool = True, n_stragglers: int = 0,
                straggler_ms: Tuple[int, int] = (250, 600), n_ooms: int = 0, oom_horizon: int = 12) -> str:
    """A schedule drawn from ``seed``, the reference's for the same
    arguments: ``n_faults`` crashes (attempt 0 only by default, so a
    retry budget always recovers), ``n_stragglers`` ``@slow`` entries of
    ``straggler_ms`` (redrawn on a collision with a crash, any attempt)
    and ``n_ooms`` ``kernel.dispatch@<hit>@oom`` entries."""
    rng = random.Random(seed)
    rules: List[Rule] = []
    seen: Set[Tuple[str, int]] = set()
    for _ in range(n_faults):
        site = sites[rng.randrange(len(sites))]
        hit = rng.randrange(1, horizon + 1)
        if (site, hit) in seen:
            continue
        seen.add((site, hit))
        rules.append((site, hit, 0 if first_attempt_only else None, None, False))
    straggler_sites = ("task.compute", "shuffle.write")
    for _ in range(n_stragglers):
        for _ in range(16):
            site = straggler_sites[rng.randrange(len(straggler_sites))]
            hit = rng.randrange(1, horizon + 1)
            if (site, hit) not in seen:
                break
        else:
            continue
        seen.add((site, hit))
        rules.append((site, hit, None, rng.randrange(straggler_ms[0], straggler_ms[1] + 1), False))
    for _ in range(n_ooms):
        for _ in range(16):
            hit = rng.randrange(1, oom_horizon + 1)
            if ("kernel.dispatch", hit) not in seen:
                break
        else:
            continue
        seen.add(("kernel.dispatch", hit))
        rules.append(("kernel.dispatch", hit, None, None, True))
    return format_spec(rules)


class FaultInjector:
    """Hit counters against a parsed schedule.  The raising probe and
    the ``@corrupt`` probe count apart: a corrupt rule's hit number is
    the Nth committed block at its site."""

    def __init__(self, rules: List[Rule], allow_kill: bool = False):
        self._by_site: Dict[str, List[Tuple[int, Optional[int], Optional[int], object]]] = {}
        self._corrupt_by_site: Dict[str, List[Tuple[int, Optional[int]]]] = {}
        for site, hit, attempt, slow_ms, kind in rules:
            if kind == "kill" and not allow_kill:
                raise ValueError(f"fault {site}@{hit}@kill: @kill is armed only in a worker process, "
                                 "through its BLAZE_FAULTS_SPEC")
            if kind == "corrupt":
                self._corrupt_by_site.setdefault(site, []).append((hit, attempt))
            else:
                self._by_site.setdefault(site, []).append((hit, attempt, slow_ms, kind))
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _count(self, key: str) -> int:
        with self._lock:
            n = self._counts.get(key, 0) + 1
            self._counts[key] = n
            return n

    def hit(self, site: str, attempt: int = 0, detail: str = "",
            cancel: Optional[threading.Event] = None) -> None:
        matches = self._by_site.get(site)
        if not matches:
            return
        n = self._count(site)
        for hit_no, want_attempt, slow_ms, kind in matches:
            if n != hit_no or (want_attempt is not None and want_attempt != attempt):
                continue
            if slow_ms is not None:
                if cancel is None:
                    time.sleep(slow_ms / 1000.0)
                else:
                    cancel.wait(slow_ms / 1000.0)
                return
            if kind is True:
                raise InjectedOom(site, n, detail)
            if kind == "enospc":
                raise InjectedDiskFull(site, n, detail)
            if kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            if site == "shuffle.fetch":
                from .retry import FetchFailedError

                raise FetchFailedError(detail or "injected", detail=f"hit {n}", injected=True)
            raise InjectedFault(site, n, detail)

    def corrupt(self, site: str, attempt: int = 0) -> bool:
        """Count one committed block at ``site``; True when an
        ``@corrupt`` rule fires for it (the caller flips a byte)."""
        matches = self._corrupt_by_site.get(site)
        if not matches:
            return False
        n = self._count(site + "#corrupt")
        return any(n == hit_no and (want is None or want == attempt) for hit_no, want in matches)


_NOOP = FaultInjector([])
_active: FaultInjector = _NOOP
_armed = False
_loaded = False
_in_worker = False
_state_lock = threading.Lock()


def mark_worker_process() -> None:
    """This process is a worker (``runtime/worker.py``): ``@kill`` rules
    of its schedule fire here."""
    global _in_worker, _loaded
    _in_worker = True
    _loaded = False


def _load_from_conf() -> None:
    global _active, _armed, _loaded
    spec = str(conf.FAULTS_SPEC.get() or "")
    with _state_lock:
        _active = FaultInjector(parse_spec(spec), allow_kill=_in_worker) if spec else _NOOP
        _armed = bool(spec)
        _loaded = True


def hit(site: str, attempt: int = 0, detail: str = "", cancel: Optional[threading.Event] = None) -> None:
    """Count one hit at ``site``; raise (or sleep, for ``@slow``, until
    ``cancel`` is set at the latest) when the schedule says this hit
    fires.  Disarmed, one bool check."""
    if not _loaded:
        _load_from_conf()
    if not _armed:
        return
    _active.hit(site, attempt, detail, cancel)


def corrupt(site: str, attempt: int = 0) -> bool:
    """The post-commit probe: True when the schedule says the Nth
    committed block at ``site`` gets a flipped byte.  Disarmed, one bool
    check."""
    if not _loaded:
        _load_from_conf()
    if not _armed:
        return False
    return _active.corrupt(site, attempt)


def reset() -> None:
    """Reload the schedule from the conf and zero the hit counters: call
    after setting ``spark.blaze.faults.spec``."""
    _load_from_conf()
