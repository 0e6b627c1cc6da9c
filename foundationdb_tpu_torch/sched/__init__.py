"""Conflict-aware transaction scheduling (copy of foundationdb_tpu/sched/).

Three independently knob-gated stages that convert doomed resolve-and-
abort round trips into useful work, grounded in "Intelligent Transaction
Scheduling via Conflict Prediction in OLTP DBMS" (arXiv 2409.01675) and
"Transaction Repair: Full Serializability Without Locks" (arXiv
1403.5645):

* **predictor** (GRV admission, ``SCHED_PREDICTOR_ENABLED``): a
  deterministic per-proxy hot-range table of decayed abort-probability
  EMAs, fed from the resolvers' conflict-heat trackers through the
  ratekeeper's poll (server/ratekeeper.py, server/grv_proxy.py).  A
  transaction whose declared tag maps to a predicted-doomed range is
  deferred (starvation-proof: ``SCHED_MAX_DEFERRALS``) instead of
  resolving into a near-certain abort; when it is finally admitted it
  reads at a FRESHER version, which is what actually saves it.
* **reorder** (commit-proxy batch assembly, ``SCHED_REORDER_ENABLED``):
  a host-side pre-pass ordering same-batch transactions so intra-batch
  readers run before the writers that would abort them (greedy
  topological order over write-vs-read interval overlap, deterministic
  tiebreak).
* **repair** (commit proxy post-resolution, ``SCHED_REPAIR_ENABLED`` +
  per-request opt-in): a transaction aborted purely on read-set
  staleness with EXACT culprit attribution is re-stamped at a fresh
  read version and re-resolved server-side
  (``TXN_REPAIR_MAX_ATTEMPTS``), converting a full client bounce into
  one extra resolver round trip.

Everything here is deterministic: no wall clock (decay is driven by
feed cadence), dict/sorted iteration only, and every stage is
bit-invisible when its knob is off.  Pure host code: no stage touches
the device; what the device sees changes only through the batches the
proxy hands its resolvers.
"""

from .predictor import ConflictPredictor
from .reorder import moved_count, reorder_batch
from .repair import RepairLadder, repair_eligible

__all__ = ["ConflictPredictor", "RepairLadder", "moved_count",
           "reorder_batch", "repair_eligible"]
