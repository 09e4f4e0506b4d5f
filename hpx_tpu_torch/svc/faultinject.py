"""Deterministic fault injection for the serving/runtime stack.

Counterpart of ``hpx_tpu.svc.faultinject``, the same module: the same
sites, types and per-site seeded streams, so one seed faults the same
nth checks in both packages. Reference analog: none in HPX proper —
this is the chaos harness the resiliency layer (`svc/resiliency`) is
tested against, in the spirit of HPX's own resiliency unit tests that
throw from inside replayed tasks.

Production code calls :func:`check` at its fault DISPATCH SITES (the
decode/prefill/verify program replays in ``models/serving.py`` and
``BlockAllocator.alloc``; the ``locality``, ``disagg.*`` and parcel
sites are typed here and get their callers with the distribution
plane); with no injector installed that is one global read and a
``None`` compare — the hot loop pays nothing.

An installed :class:`FaultInjector` decides *deterministically* whether
the Nth check of a site faults:

* an explicit **schedule** — ``{"decode": {3, 10}}`` faults the 3rd and
  10th decode checks, nothing else; the precision tool for tests;
* a seeded **rate** — every check draws from a per-site
  ``random.Random`` stream (streams are independent, so adding checks
  of one site never perturbs another's draws); same seed + same call
  order = same faults, which is what lets the chaos bench demand
  sha-identical output across a faulted and a fault-free run.

Faults are typed by site: ``alloc`` raises :class:`InjectedOOM` (a
``CacheOOM`` subclass — it walks the allocator's evict→retry→shed
ladder), ``locality`` and the ``disagg.*`` worker sites raise
:class:`LocalityLost` (a ``NetworkError`` —
`async_replay_distributed` retargets on it), everything else raises
plain :class:`InjectedFault`. All carry ``.site`` and ``.nth`` so
recovery policy can classify (e.g. serving disables speculation after
repeated ``verify`` faults).

The parcel sites (``parcel.drop``/``parcel.dup``/``parcel.delay``/
``net.partition``) are BEHAVIORAL: their fault is an action (lose,
duplicate or delay a wire message; tear a link) rather than an
exception, so their dispatch points call :func:`fires` — the same
deterministic decision (schedule nth membership, or a per-site seeded
stream draw) returned as a bool instead of raised; the parcel layer,
when it is ported, consults them.

Config (``hpx.fault.*``)::

    hpx.fault.enable     install_from_config() installs when truthy
    hpx.fault.seed       RNG seed for rate-based injection
    hpx.fault.rate       per-check fault probability
    hpx.fault.sites      csv of armed sites ("" = all)
    hpx.fault.max        total fault cap (0 = unlimited)
    hpx.fault.schedule   csv "site:nth" explicit schedule entries
"""

from __future__ import annotations

import random
from typing import Dict, Iterable, Mapping, Optional, Set, Tuple

from ..core.errors import (CacheOOM, Error, HpxError,
                           LocalityLost as _RealLocalityLost)
from ..synchronization import Mutex

__all__ = [
    "FaultInjector",
    "InjectedFault",
    "InjectedOOM",
    "LocalityLost",
    "SITES",
    "active",
    "check",
    "fires",
    "install",
    "install_from_config",
    "uninstall",
]

# the known dispatch sites, for docs/validation (unknown site names are
# still allowed — subsystems may grow new sites without touching this).
# "disagg.prefill"/"disagg.decode" are the per-ROLE worker-call sites
# (each counts its own stream, so a schedule can kill exactly one
# worker of each role); the parcel.* / net.partition sites are
# behavioral (fires(), not check()).
SITES = ("decode", "prefill", "verify", "alloc", "locality",
         "disagg.prefill", "disagg.decode",
         "parcel.drop", "parcel.dup", "parcel.delay", "net.partition")


class InjectedFault(HpxError):
    """A fault the injector raised at a dispatch site — the serving
    retry/restore ladder treats it as transient and recoverable."""

    def __init__(self, site: str, nth: int, message: str = ""):
        super().__init__(Error.internal_server_error,
                         message or f"injected fault at site "
                         f"{site!r} (check #{nth})",
                         "FaultInjector.check")
        self.site = site
        self.nth = nth


class InjectedOOM(CacheOOM, InjectedFault):
    """Injected pool exhaustion: isinstance of BOTH CacheOOM (so the
    allocator's callers run their normal OOM→evict→retry discipline)
    and InjectedFault (so fault accounting sees it)."""

    def __init__(self, site: str, nth: int):
        CacheOOM.__init__(
            self, f"injected KV-pool OOM (check #{nth})",
            "FaultInjector.check")
        self.site = site
        self.nth = nth


class LocalityLost(_RealLocalityLost, InjectedFault):
    """Simulated locality loss on the action send path — what a died
    decode/prefill worker looks like to `dist/actions` callers;
    `async_replay_distributed` retargets the next locality on it.
    Subclasses the REAL `core.errors.LocalityLost` the failure
    detector raises, so one except clause handles both worlds."""

    def __init__(self, site: str, nth: int, locality: int = -1):
        _RealLocalityLost.__init__(
            self, locality,
            f"injected locality loss toward locality "
            f"{locality} (check #{nth})", "FaultInjector.check")
        self.site = site
        self.nth = nth


def _raise_for(site: str, nth: int, **ctx) -> None:
    if site == "alloc":
        raise InjectedOOM(site, nth)
    if site == "locality" or site.startswith("disagg."):
        raise LocalityLost(site, nth, int(ctx.get("locality", -1)))
    raise InjectedFault(site, nth)


class FaultInjector:
    """Deterministic per-site fault source. Thread-safe: per-site
    check counters and RNG draws mutate under one Mutex (sites fire
    from the serving loop, the allocator, and action senders)."""

    def __init__(self, seed: int = 0, rate: float = 0.0,
                 sites: Optional[Iterable[str]] = None,
                 max_faults: int = 0,
                 schedule: Optional[Mapping[str, Iterable[int]]] = None,
                 ) -> None:
        if rate < 0.0 or rate > 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {rate}")
        self.seed = int(seed)
        self.rate = float(rate)
        self.sites: Optional[Set[str]] = (None if sites is None
                                          else {s for s in sites if s})
        self.max_faults = int(max_faults)
        self.schedule: Dict[str, Set[int]] = {
            site: {int(n) for n in nths}
            for site, nths in (schedule or {}).items()}
        self._rngs: Dict[str, random.Random] = {}
        self._checks: Dict[str, int] = {}
        self._injected: Dict[str, int] = {}
        self._lock = Mutex()

    # -- the decision -----------------------------------------------------

    def _armed(self, site: str) -> bool:
        return self.sites is None or site in self.sites

    def _decide(self, site: str) -> Tuple[bool, int]:
        """One counted dispatch through `site` → (fires, nth). Called
        under self._lock."""
        nth = self._checks.get(site, 0) + 1
        self._checks[site] = nth
        if not self._armed(site):
            return False, nth
        total = sum(self._injected.values())
        if self.max_faults and total >= self.max_faults:
            return False, nth
        fire = nth in self.schedule.get(site, ())
        if not fire and self.rate > 0.0:
            rng = self._rngs.get(site)
            if rng is None:
                # independent per-site streams: one site's check
                # count never perturbs another site's draws
                rng = random.Random(f"{self.seed}:{site}")
                self._rngs[site] = rng
            fire = rng.random() < self.rate
        if fire:
            self._injected[site] = self._injected.get(site, 0) + 1
        return fire, nth

    def check(self, site: str, **ctx) -> None:
        """Count one dispatch through `site`; raise its typed fault if
        the schedule/rate says this one dies."""
        with self._lock:
            fire, nth = self._decide(site)
        if fire:
            _raise_for(site, nth, **ctx)

    def fires(self, site: str, **ctx) -> bool:
        """`check` for BEHAVIORAL sites: same deterministic decision
        (same counters, same streams), returned instead of raised —
        the dispatch point acts the fault out (drop/duplicate/delay a
        parcel, tear a link) rather than unwinding."""
        with self._lock:
            fire, _nth = self._decide(site)
        return fire

    # -- observability ----------------------------------------------------

    def stats(self) -> Dict[str, Dict[str, int]]:
        """{site: {"checks": N, "injected": M}} for every site seen."""
        with self._lock:
            return {site: {"checks": n,
                           "injected": self._injected.get(site, 0)}
                    for site, n in sorted(self._checks.items())}

    @property
    def total_injected(self) -> int:
        with self._lock:
            return sum(self._injected.values())


# -- process-wide installation (one injector; None = everything passes) -----

_active: Optional[FaultInjector] = None


def install(injector: FaultInjector) -> FaultInjector:
    """Install `injector` as THE process-wide fault source (replacing
    any previous one) and return it."""
    global _active
    _active = injector
    return injector


def uninstall() -> Optional[FaultInjector]:
    """Remove the active injector (returns it); checks become no-ops."""
    global _active
    fi, _active = _active, None
    return fi


def active() -> Optional[FaultInjector]:
    return _active


def check(site: str, **ctx) -> None:
    """The dispatch-site hook: no-op unless an injector is installed."""
    fi = _active
    if fi is not None:
        fi.check(site, **ctx)


def fires(site: str, **ctx) -> bool:
    """Behavioral-site hook: False unless an injector is installed and
    schedules this dispatch."""
    fi = _active
    if fi is not None:
        return fi.fires(site, **ctx)
    return False


def install_from_config() -> Optional[FaultInjector]:
    """Build + install an injector from ``hpx.fault.*`` when
    ``hpx.fault.enable`` is truthy; returns it (or None when fault
    injection is off). Operator entry point — tests and the chaos
    bench construct FaultInjector directly for precise schedules."""
    from ..core.config import runtime_config
    rc = runtime_config()
    if not rc.get_bool("hpx.fault.enable", False):
        return None
    sites_csv = (rc.get("hpx.fault.sites") or "").strip()
    sites = ([s.strip() for s in sites_csv.split(",") if s.strip()]
             or None)
    schedule: Dict[str, Set[int]] = {}
    for part in (rc.get("hpx.fault.schedule") or "").split(","):
        part = part.strip()
        if not part:
            continue
        site, _, nth = part.partition(":")
        if not nth:
            raise ValueError(
                f"hpx.fault.schedule entries are site:nth, got {part!r}")
        schedule.setdefault(site.strip(), set()).add(int(nth))
    return install(FaultInjector(
        seed=rc.get_int("hpx.fault.seed", 0),
        rate=rc.get_float("hpx.fault.rate", 0.0),
        sites=sites,
        max_faults=rc.get_int("hpx.fault.max", 0),
        schedule=schedule))
