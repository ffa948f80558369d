"""The Pig relay-group configuration and static partition (copied from
``repro.core.pig``): what the batch lowering needs to build groups and
their PRC flush thresholds."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence


@dataclass
class PigConfig:
    n_groups: int = 1
    rotate_relays: bool = True          # False => static relay (Fig 8 baseline)
    prc: int = 0                        # of slowest group members to not wait on (§4.1)
    relay_timeout: float = 10e-3        # T_r (must be << leader timeout T_l, §3.4)
    single_group_majority: bool = False  # §4.3 optimization for R == 1
    use_gray_list: bool = False         # §4.2
    gray_duration: float = 2.0
    gray_probe_prob: float = 0.02
    groups: Optional[List[List[int]]] = None   # explicit (e.g. per-region, §5.3)
    # elasticity: re-derive R from the *current* membership on every
    # re-partition instead of keeping n_groups fixed
    auto_groups: bool = False


def partition_followers(members: Sequence[int], r: int) -> List[List[int]]:
    """Round-robin partition of the followers into ``r`` relay groups."""
    r = max(1, min(r, len(members)))
    out: List[List[int]] = [[] for _ in range(r)]
    for i, m in enumerate(members):
        out[i % r].append(m)
    return out


def required_per_group(groups: List[List[int]], n: int, prc: int,
                       single_group_majority: bool) -> List[int]:
    """PRC thresholds q_i = n_i - PRC, subject to the paper's §4.1
    constraint sum(q_i) >= majority - 1 (the leader votes for itself).
    ``single_group_majority`` is the §4.3 R == 1 global-majority shortcut."""
    maj = n // 2 + 1
    if single_group_majority and len(groups) == 1:
        return [min(len(groups[0]), maj - 1)]     # §4.3: global majority
    req = [max(1, len(g) - prc) for g in groups]
    i = 0
    while sum(req) < maj - 1:
        if req[i % len(req)] < len(groups[i % len(req)]):
            req[i % len(req)] += 1
        i += 1
        if i > 4 * len(req):       # all groups already at n_i
            break
    return req
