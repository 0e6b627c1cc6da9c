"""Replication policy DSL (a copy of foundationdb_tpu/server/policy.py;
reference flow/ReplicationPolicy.h/.cpp).

The reference expresses placement constraints as composable policies —
PolicyOne, PolicyAcross(n, attributeKey, inner), PolicyAnd — evaluated
both to SELECT teams from candidate sets and to VALIDATE that an
existing team still satisfies the configuration (e.g. `three_data_hall`
= Across(3, data_hall, Across(2, zoneid, One()))).  This module is that
engine over the framework's locality tuples; data distribution and
recruitment use it for team selection instead of ad-hoc zone loops.

Candidates are (id, locality_dict) pairs; locality_dict carries
"dcid"/"zoneid"/"machineid" (and anything else a deployment stamps).
select() is deterministic greedy — order-stable for the simulator.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

Candidate = Tuple[Any, Dict[str, str]]


class ReplicationPolicy:
    def n_required(self) -> int:
        raise NotImplementedError

    def validate(self, team: Sequence[Candidate]) -> bool:
        raise NotImplementedError

    def select(self, candidates: Sequence[Candidate]
               ) -> Optional[List[Candidate]]:
        """A minimal team satisfying the policy, or None."""
        raise NotImplementedError

    def name(self) -> str:
        raise NotImplementedError


class PolicyOne(ReplicationPolicy):
    """One replica, anywhere (reference PolicyOne)."""

    def n_required(self) -> int:
        return 1

    def validate(self, team) -> bool:
        return len(team) >= 1

    def select(self, candidates):
        return [candidates[0]] if candidates else None

    def name(self) -> str:
        return "One"


class PolicyAcross(ReplicationPolicy):
    """n groups with DISTINCT values of `attr`, each satisfying `inner`
    (reference PolicyAcross: e.g. Across(2, "zoneid", One()) = two
    replicas in two different zones)."""

    def __init__(self, n: int, attr: str,
                 inner: Optional[ReplicationPolicy] = None) -> None:
        self.n = n
        self.attr = attr
        self.inner = inner or PolicyOne()

    def n_required(self) -> int:
        return self.n * self.inner.n_required()

    def _groups(self, team) -> Dict[str, List[Candidate]]:
        groups: Dict[str, List[Candidate]] = {}
        for c in team:
            # An unset attribute makes each candidate its own group (the
            # reference treats missing locality as unique — safe-diverse).
            key = c[1].get(self.attr) or f"__unique__{c[0]}"
            groups.setdefault(key, []).append(c)
        return groups

    def validate(self, team) -> bool:
        ok = sum(1 for members in self._groups(team).values()
                 if self.inner.validate(members))
        return ok >= self.n

    def select(self, candidates):
        groups = self._groups(candidates)
        # Deterministic: biggest groups first (most inner headroom), then
        # group key for stability.
        picked: List[Candidate] = []
        used = 0
        for key in sorted(groups, key=lambda k: (-len(groups[k]), str(k))):
            inner_team = self.inner.select(groups[key])
            if inner_team is not None:
                picked.extend(inner_team)
                used += 1
                if used == self.n:
                    return picked
        return None

    def name(self) -> str:
        return f"Across({self.n},{self.attr},{self.inner.name()})"


class PolicyAnd(ReplicationPolicy):
    """Every sub-policy must hold over the same team (reference
    PolicyAnd)."""

    def __init__(self, *policies: ReplicationPolicy) -> None:
        self.policies = list(policies)

    def n_required(self) -> int:
        return max((p.n_required() for p in self.policies), default=0)

    def validate(self, team) -> bool:
        return all(p.validate(team) for p in self.policies)

    def select(self, candidates):
        # Greedy: select for the most demanding policy, then grow the
        # team with further candidates until every policy validates.
        base = max(self.policies, key=lambda p: p.n_required(),
                   default=None)
        if base is None:
            return []
        team = base.select(candidates)
        if team is None:
            return None
        ids = {c[0] for c in team}
        for c in candidates:
            if self.validate(team):
                return team
            if c[0] not in ids:
                team = team + [c]
                ids.add(c[0])
        return team if self.validate(team) else None

    def name(self) -> str:
        return "And(" + ",".join(p.name() for p in self.policies) + ")"


def policy_from_config(replication: int, attr: str = "zoneid"
                       ) -> ReplicationPolicy:
    """The policy a numeric replication factor means (reference
    DatabaseConfiguration::setDefaultReplicationPolicy): `n` replicas in
    `n` distinct failure zones."""
    if replication <= 1:
        return PolicyOne()
    return PolicyAcross(replication, attr, PolicyOne())


# Named policies (reference configuration strings).
def three_data_hall() -> ReplicationPolicy:
    return PolicyAcross(3, "data_hall", PolicyAcross(2, "zoneid",
                                                     PolicyOne()))
