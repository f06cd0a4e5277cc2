"""Capacity-overflow retry of the CLI (SURVEY.md §7 "capacity planning"); the
port's copy of repkiller_tpu/utils/capacity.py.

The device pipeline over-allocates static arrays and raises ValueError with
the true counts when a capacity is exceeded (device.compare) instead of
silently truncating. `grow_capacity` maps such an error message to a Config
with the offending capacity doubled; `with_auto_capacity` wraps any
cfg-taking callable with a doubling retry loop so new workloads self-tune
unattended instead of dying on an undersized first guess.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple, TypeVar

from ..config import Config

log = logging.getLogger("repkiller_tpu")

T = TypeVar("T")


def grow_capacity(cfg: Config, msg: str) -> Optional[Tuple[Config, str]]:
    """Map a capacity-overflow ValueError message to (doubled Config,
    human-readable description), or None if the error is not a recognised
    overflow."""
    if "hit_capacity" in msg and "overflow" in msg:
        return (cfg.replace(hit_capacity=cfg.hit_capacity * 2),
                f"hit_capacity={cfg.hit_capacity * 2}")
    if "seed_capacity" in msg and "overflow" in msg:
        return (cfg.replace(seed_capacity=cfg.seed_cap * 2,
                            hit_capacity=max(cfg.hit_capacity,
                                             cfg.seed_cap * 2)),
                f"seed_capacity={cfg.seed_cap * 2}")
    if "shard_slack" in msg:
        return (cfg.replace(shard_slack=cfg.shard_slack * 2),
                f"shard_slack={cfg.shard_slack * 2}")
    if "frag capacity overflow" in msg:
        return (cfg.replace(seed_capacity=cfg.seed_cap * 2,
                            hit_capacity=max(cfg.hit_capacity,
                                             cfg.seed_cap * 2)),
                f"seed_capacity={cfg.seed_cap * 2}")
    return None


def with_auto_capacity(fn: Callable[[Config], T], cfg: Config,
                       retries: int = 4) -> Tuple[T, Config]:
    """Run fn(cfg); on a recognised capacity-overflow ValueError double the
    offending capacity and retry, up to `retries` times. Returns
    (result, config_actually_used) so callers can keep the grown config for
    subsequent (e.g. timed) calls. Unrecognised errors propagate."""
    for attempt in range(retries + 1):
        try:
            return fn(cfg), cfg
        except ValueError as e:
            grown = grow_capacity(cfg, str(e))
            if grown is None or attempt == retries:
                raise
            log.warning("%s — retrying with %s (attempt %d/%d)",
                        e, grown[1], attempt + 1, retries)
            cfg = grown[0]
    raise AssertionError("unreachable")
