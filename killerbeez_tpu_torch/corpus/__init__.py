"""Persistent corpus: the store and the seed schedulers.

  * ``store.py``    — on-disk corpus store: one buffer file per entry
    keyed by md5 plus a JSON metadata sidecar (coverage signature,
    bandit stats, lineage, discovery order), atomic-rename writes,
    and the campaign checkpoint that lets ``--resume`` continue a
    killed campaign where it stopped.
  * ``schedule.py`` — the seed-scheduling policy behind the loop's
    rotation: ``bandit`` (the default greedy-optimistic decay bandit
    with splice) and ``rr`` (round-robin baseline).  The JAX
    package's ``rare-edge`` policy comes with the edge signer it
    needs.

Both keep the JAX package's on-disk formats, so either package
resumes the other's corpus.  Corpus sync, gossip and quarantine are
not ported yet.
"""

from __future__ import annotations

from .schedule import (
    Arm, BanditScheduler, RoundRobinScheduler,
    SCHEDULERS, Scheduler, make_scheduler,
)
from .store import CorpusEntry, CorpusStore

__all__ = [
    "Arm", "BanditScheduler", "CorpusEntry", "CorpusStore",
    "RoundRobinScheduler", "SCHEDULERS",
    "Scheduler", "make_scheduler",
]
