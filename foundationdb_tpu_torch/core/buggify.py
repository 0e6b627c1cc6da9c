"""BUGGIFY fault-injection sites (reference flow/flow.h:80-89).

A buggify site is identified by a string name. In simulation, each site is
deterministically enabled with probability P_BUGGIFIED_SECTION_ACTIVATED per
run; an enabled site then fires with P_BUGGIFIED_SECTION_FIRES per evaluation.
Outside simulation buggify() is always False.

The port's switch and sites are its own: enabling another package's
buggify leaves these off, so a simulation that does not force a site here
never fires it.
"""

from __future__ import annotations

from typing import Dict

from .rng import deterministic_random

P_ACTIVATED = 0.25
P_FIRES = 0.25

_enabled = False
_site_active: Dict[str, bool] = {}
# Deterministic per-site overrides (tests/chaos drivers): True = the site
# fires on EVERY evaluation, False = never, absent = probabilistic.
# Overrides apply even with buggify globally disabled, so a chaos test
# can kill exactly one site without randomizing every other one.
_forced: Dict[str, bool] = {}


def enable_buggify(on: bool = True) -> None:
    global _enabled
    _enabled = on
    _site_active.clear()


def buggify_enabled() -> bool:
    return _enabled


def force_buggify(site: str, fire: bool = True) -> None:
    """Pin a site: buggify(site) returns `fire` until unforce_buggify."""
    _forced[site] = fire


def unforce_buggify(site: str = None) -> None:
    """Drop one forced site (or all of them with no argument)."""
    if site is None:
        _forced.clear()
    else:
        _forced.pop(site, None)


def buggify(site: str) -> bool:
    """True (rarely, deterministically) when fault injection should happen."""
    if site in _forced:
        return _forced[site]
    if not _enabled:
        return False
    rng = deterministic_random()
    active = _site_active.get(site)
    if active is None:
        active = rng.random01() < P_ACTIVATED
        _site_active[site] = active
    return active and rng.random01() < P_FIRES
