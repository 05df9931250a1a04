"""Hybrid native⇄device campaign bridge — so far its reconciliation.

:mod:`.reconcile` holds the per-tier coverage reconciliation the
manager's fleet view needs: tier tags on entries, heartbeats and
gossip rows, per-tier fleet folds and the native-tier heartbeat.  The
bridge's other pieces (the proxy bindings and their certification,
seed translation, cross-tier validation and the proxy-gap store) are
not ported yet.
"""

from .reconcile import (  # noqa: F401
    DEFAULT_TIER,
    NativeHeartbeat,
    tier_of,
)
