"""Persistent corpus: the store, the seed schedulers and the fleet's
corpus exchange.

  * ``store.py``    — on-disk corpus store: one buffer file per entry
    keyed by md5 plus a JSON metadata sidecar (coverage signature,
    bandit stats, lineage, discovery order), atomic-rename writes,
    and the campaign checkpoint that lets ``--resume`` continue a
    killed campaign where it stopped.
  * ``schedule.py`` — the seed-scheduling policy behind the loop's
    rotation: ``bandit`` (the default greedy-optimistic decay bandit
    with splice), ``rare-edge`` (FairFuzz-style rarity over the
    corpus-wide edge hits, fed by the loop's edge signer) and ``rr``
    (round-robin baseline).
  * ``sync.py``     — manager-mediated corpus exchange: workers POST
    edge-novel entries to ``/api/corpus/<campaign>`` and periodically
    pull peers' entries into their local store (coverage-hash dedup,
    heartbeat-style retry/backoff).
  * ``gossip.py``   — peer-to-peer corpus gossip: every worker serves
    its own entries behind the same cursor API (``GossipSidecar``)
    and pulls a random fanout of peers each round, with the manager
    demoted to peer directory + anti-entropy backstop.
  * ``quarantine.py`` — the poisoned-entry gate on every synced-in
    row: schema/size validation, ``cov_hash`` recompute, disk
    quarantine and decorrelated-backoff peer bans.

All keep the JAX package's on-disk and wire formats, so either package
resumes the other's corpus, and a fleet may mix both packages'
workers.
"""

from __future__ import annotations

from .schedule import (
    Arm, BanditScheduler, RareEdgeScheduler, RoundRobinScheduler,
    SCHEDULERS, Scheduler, make_scheduler,
)
from .gossip import GossipSidecar, GossipSync
from .quarantine import EntryValidator, PeerBans, QuarantineStore
from .store import CorpusEntry, CorpusStore
from .sync import CorpusSync

__all__ = [
    "Arm", "BanditScheduler", "CorpusEntry", "CorpusStore",
    "CorpusSync", "EntryValidator", "GossipSidecar", "GossipSync",
    "PeerBans", "QuarantineStore", "RareEdgeScheduler", "RoundRobinScheduler", "SCHEDULERS",
    "Scheduler", "make_scheduler",
]
