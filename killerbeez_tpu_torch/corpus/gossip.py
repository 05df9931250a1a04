"""Peer-to-peer corpus gossip — corpus flow without a living hub.

The manager-mediated exchange (sync.py) makes the manager the sole
corpus distributor: every entry flows worker -> hub -> workers, so a
partitioned, slow or dead manager stops fleet-wide corpus flow cold
(the decorrelated sync backoff keeps workers *fuzzing*, but each one
re-discovers what its peers already know).  The reference solved fleet scale with a BOINC
work-distribution tier; this module solves it the epidemic way:

  * every gossiping worker runs a :class:`GossipSidecar` — a small
    HTTP server exposing the SAME cursor API the manager serves
    (``GET /api/corpus/<campaign>?since=N``), backed by the worker's
    own admitted entries;
  * each sync round, :class:`GossipSync` picks ``fanout`` random
    live peers from the peer directory and pulls their cursors
    directly, deduping by the existing ``cov_hash`` exactly like the
    manager path — one worker's frontier reaches the whole fleet in
    O(log n) rounds with no hub on the data path;
  * the manager is demoted to **peer directory + anti-entropy
    backstop**: ``POST /api/peers/<campaign>`` registers this
    worker's endpoint and returns the current directory (one round
    trip), and the inherited manager push/pull still runs when the
    hub is reachable, catching up stragglers and late joiners.  The
    directory is CACHED — a dead manager stops refreshes, not gossip.

Trust boundary: everything pulled from a peer passes the
poisoned-entry quarantine (``quarantine.EntryValidator``) before
admission; a peer whose entries keep failing validation is banned
for a decorrelated-backoff interval (``quarantine.PeerBans``).
Outbound peer requests ride the same ``manager_rpc`` chaos seam as
hub traffic (one `--chaos` spec covers both; ``match`` scopes a
partition to a named endpoint), and the sidecar's serve path carries
its own ``gossip_serve`` seam.
"""

from __future__ import annotations

import base64
import json
import os
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Set
from urllib.parse import parse_qs, urlparse

from ..resilience.chaos import chaos_point
from ..utils.logging import DEBUG_MSG, INFO_MSG
from .quarantine import EntryValidator, PeerBans
from .store import CorpusEntry
from .sync import CorpusSync


class GossipSidecar:
    """One worker's corpus server: an append-only METADATA log (the
    content bytes live in the attached corpus store and are read at
    serve time) behind the manager's cursor-GET shape, so the pull
    client is the same code for hub and peers.  Responses are paged.

        GET /api/corpus/<campaign>?since=N[&limit=K]
            -> {campaign, boot, latest, entries: [...]}
        GET /api/ping -> {worker, campaign, entries, boot}

    ``boot`` is a per-process nonce: a restarted sidecar restarts its
    row ids at 0, and the nonce tells pullers to reset their cursor
    instead of silently missing everything below their stale one.
    """

    #: default per-GET page cap (bounds response size; pullers catch
    #: up across rounds — cov_hash dedup makes overlap harmless)
    PAGE = 256

    def __init__(self, campaign: str, worker: str,
                 host: str = "127.0.0.1", port: int = 0):
        self.campaign = str(campaign)
        self.worker = worker
        self.boot = f"{time.time():.0f}-{random.randrange(1 << 30)}"
        self._rows: List[Dict[str, Any]] = []
        self._known: Set[str] = set()        # cov_hashes published
        self._lock = threading.Lock()
        self.served_n = 0                    # entries served out
        #: the worker's durable corpus store, once attached: rows
        #: then hold METADATA ONLY and content is read from disk at
        #: serve time — the sidecar must not carry a second full
        #: copy of the corpus in heap (content dominates; a long
        #: campaign's store is arbitrarily large).  Entries with no
        #: store backing keep their bytes in the row.
        self.store = None
        sidecar = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                try:
                    # chaos seam: inbound peer traffic — the ctx url
                    # carries this sidecar's endpoint, so a partition
                    # ``match``-scoped to one worker's host:port
                    # severs exactly that worker's serving
                    chaos_point("gossip_serve",
                                url=sidecar.endpoint + self.path)
                    sidecar._serve(self)
                except Exception as e:   # serving must never kill us
                    try:
                        self.send_error(500, str(e)[:100])
                    except OSError:
                        pass

        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.port = self.httpd.server_address[1]
        self.endpoint = f"http://{host}:{self.port}"
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    # -- publishing -----------------------------------------------------

    def publish(self, entry: CorpusEntry) -> bool:
        """Append one locally-admitted entry to the served log (local
        finds AND entries learned from peers — re-serving what we
        learned is what makes the epidemic converge).  Dedup by
        cov_hash; returns True when newly published.  Bytes stay in
        the row ONLY while no attached store holds them."""
        with self._lock:
            if entry.cov_hash in self._known:
                return False
            self._known.add(entry.cov_hash)
            row: Dict[str, Any] = {
                "id": len(self._rows) + 1,
                "md5": entry.md5,
                "cov_hash": entry.cov_hash,
                "worker": self.worker,
                "meta": entry.meta_dict(),
            }
            if not self._store_has(entry.md5):
                row["_buf"] = bytes(entry.buf)
            self._rows.append(row)
        return True

    def _store_has(self, md5: str) -> bool:
        store = self.store
        if store is None:
            return False
        try:
            return os.path.exists(store.entry_path(md5))
        except OSError:
            return False

    def attach_store(self, store) -> None:
        """Wire the durable corpus store in (the sync round does this
        on its serve-side bootstrap) and drop every cached buffer the
        store already holds — heap shrinks to metadata."""
        if store is None:
            return
        with self._lock:
            self.store = store
            for row in self._rows:
                if "_buf" in row and self._store_has(row["md5"]):
                    del row["_buf"]

    def _row_content_b64(self, row: Dict[str, Any]) -> Optional[str]:
        """Wire content for one row: the raw forged row's b64 (tests
        publish those directly), the cached buffer, or a store read."""
        if isinstance(row.get("content_b64"), str):
            return row["content_b64"]
        buf = row.get("_buf")
        if buf is None and self.store is not None:
            try:
                with open(self.store.entry_path(row["md5"]),
                          "rb") as f:
                    buf = f.read()
            except OSError:
                return None
        if buf is None:
            return None
        return base64.b64encode(buf).decode()

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    # -- serving --------------------------------------------------------

    def _serve(self, handler) -> None:
        parsed = urlparse(handler.path)
        query = parse_qs(parsed.query)
        if parsed.path == "/api/ping":
            self._json(handler, 200, {
                "worker": self.worker, "campaign": self.campaign,
                "boot": self.boot, "entries": len(self)})
            return
        if parsed.path == f"/api/corpus/{self.campaign}":
            since = int(query.get("since", ["0"])[0])
            limit = int(query.get("limit", [str(self.PAGE)])[0])
            limit = max(1, min(limit, self.PAGE))
            with self._lock:
                latest = len(self._rows)
                page = list(self._rows[since:since + limit])
            out = []
            for row in page:
                b64 = self._row_content_b64(row)
                if b64 is None:
                    # unreadable store entry: serve the rest of the
                    # page (its ids still advance the puller's
                    # cursor); the row retries on a later pull
                    continue
                out.append({"id": row["id"], "md5": row["md5"],
                            "cov_hash": row["cov_hash"],
                            "worker": row["worker"],
                            "meta": row["meta"],
                            "content_b64": b64})
            with self._lock:
                self.served_n += len(out)
            self._json(handler, 200, {
                "campaign": self.campaign, "boot": self.boot,
                "latest": latest, "entries": out})
            return
        self._json(handler, 404,
                   {"error": f"no route {parsed.path}"})

    @staticmethod
    def _json(handler, code: int, obj: Any) -> None:
        body = json.dumps(obj).encode()
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=5)


class GossipSync(CorpusSync):
    """The partition-tolerant exchange client: manager anti-entropy
    (inherited) + per-round peer fanout pulls + a serving sidecar.

    Rides the loop's existing sync hook unchanged — ``note_entry`` at
    triage, ``maybe_sync`` between batches — so ``--gossip`` is a
    flag, not a new loop mode.  Peer transport failures never fail
    the ROUND (the round gate and its backoff stay manager-signal
    only); a failed peer is simply skipped until a later round's
    random fanout picks it again."""

    def __init__(self, manager_url: str, campaign: str,
                 worker: str = "anon", interval_s: float = 30.0,
                 attempts: int = 1,
                 backoff_cap: Optional[float] = None,
                 rng: Optional[random.Random] = None,
                 validator: Optional[EntryValidator] = None,
                 fanout: int = 2,
                 listen_host: str = "127.0.0.1",
                 listen_port: int = 0,
                 advertise: Optional[str] = None,
                 peer_refresh_rounds: int = 4,
                 bans: Optional[PeerBans] = None):
        super().__init__(manager_url, campaign, worker=worker,
                         interval_s=interval_s, attempts=attempts,
                         backoff_cap=backoff_cap, rng=rng,
                         validator=validator)
        self.fanout = int(fanout)
        self.sidecar = GossipSidecar(campaign, worker,
                                     host=listen_host,
                                     port=listen_port)
        #: the URL peers reach us at (defaults to the bind address —
        #: override when NAT/containers make that unreachable)
        self.advertise = advertise or self.sidecar.endpoint
        self.peers_url = (f"{self.manager_url}/api/peers/"
                          f"{self.campaign}")
        #: cached peer directory {worker: endpoint} — survives a dead
        #: manager (gossip outlives the hub on the last known fleet)
        self.peers: Dict[str, str] = {}
        self.peer_refresh_rounds = max(1, int(peer_refresh_rounds))
        self._rounds = 0
        #: per-peer pull cursor {worker: [boot, since]}
        self._peer_cursor: Dict[str, List[Any]] = {}
        self.bans = bans or PeerBans(rng=self._rng)
        self._served_seen = 0
        self._store_published = False
        self.gossip_pulled_n = 0
        INFO_MSG("gossip sidecar for %s serving on %s", worker,
                 self.advertise)

    def close(self) -> None:
        self.sidecar.close()

    # -- publishing hooks ----------------------------------------------

    def note_entry(self, entry: CorpusEntry) -> None:
        super().note_entry(entry)
        self.sidecar.publish(entry)

    def _admit_entries(self, fuzzer, entries) -> int:
        admitted = super()._admit_entries(fuzzer, entries)
        for e in entries:
            self.sidecar.publish(e)
        return admitted

    # -- peer directory -------------------------------------------------

    def _refresh_peers(self) -> None:
        """Register our endpoint and pull the directory in ONE
        request; a failure keeps the cached directory — the manager
        is only the phone book, never the data path."""
        from ..manager.worker import _request_retry
        try:
            resp = _request_retry(
                self.peers_url,
                {"worker": self.worker, "endpoint": self.advertise},
                attempts=self.attempts)
        except Exception as e:
            DEBUG_MSG("gossip: peer-directory refresh failed "
                      "(cached %d peers kept): %s", len(self.peers), e)
            return
        if not isinstance(resp, dict):
            return
        peers = {}
        for p in resp.get("peers", []):
            if not isinstance(p, dict):
                continue
            w, ep = p.get("worker"), p.get("endpoint")
            if isinstance(w, str) and isinstance(ep, str) \
                    and w != self.worker:
                peers[w] = ep
        if not peers and self.peers:
            # an EMPTY directory never replaces a non-empty cache: a
            # write-degraded manager freezes last_seen fleet-wide, so
            # after dead_after its directory reads empty while every
            # peer is actually alive — overwriting the cache here
            # would halt gossip during exactly the outage it exists
            # to survive (stale cached peers just fail their pulls)
            DEBUG_MSG("gossip: empty peer directory (manager "
                      "degraded=%s); keeping %d cached peers",
                      resp.get("degraded"), len(self.peers))
            return
        self.peers = peers

    # -- the peer exchange round ---------------------------------------

    def _pull_peer(self, fuzzer, name: str, endpoint: str) -> int:
        """One cursor GET against one peer; returns entries admitted
        (-1 on transport failure).  Rides the manager_rpc chaos seam
        (worker._request), so ``--chaos`` specs cover peer traffic."""
        from ..manager.worker import _request_retry
        cur = self._peer_cursor.setdefault(name, [None, 0])
        url = (f"{endpoint.rstrip('/')}/api/corpus/{self.campaign}"
               f"?since={cur[1]}")
        try:
            resp = _request_retry(url, None, method="GET",
                                  attempts=self.attempts)
        except Exception as e:
            DEBUG_MSG("gossip: pull from peer %s (%s) failed: %s",
                      name, endpoint, e)
            return -1
        if not isinstance(resp, dict):
            return 0
        boot = resp.get("boot")
        if cur[0] is not None and boot != cur[0]:
            # peer restarted: its ids restarted too, and THIS response
            # was served against our stale cursor — reset and re-pull
            # from 0 next round (cov_hash dedup absorbs the overlap);
            # advancing the cursor from this response would clobber
            # the reset and skip everything the restarted peer serves
            cur[0], cur[1] = boot, 0
            return 0
        cur[0] = boot
        rows = resp.get("entries", [])
        # advance by the PAGE actually returned, never to `latest`:
        # the sidecar truncates responses to its page cap, and a
        # cursor jumped to latest would permanently skip the rows the
        # truncated page did not carry.  Ids parse PER ROW — one
        # malformed id from a hostile peer must not blow the whole
        # page's advance and fall back to the latest-jump
        ids = []
        if isinstance(rows, list):
            for r in rows:
                if not isinstance(r, dict):
                    continue
                try:
                    ids.append(int(r.get("id", 0)))
                except (TypeError, ValueError):
                    continue
        if ids:
            cur[1] = max([cur[1]] + ids)
        elif not rows:
            # an EMPTY page means the cursor is at (or past) the
            # peer's tail — latest is then safe to trust as a floor
            try:
                cur[1] = max(cur[1], int(resp.get("latest", 0)))
            except (TypeError, ValueError):
                pass
        before = len(self._quarantined_round)
        entries = self._entries_from_rows(rows, peer=name)
        if len(self._quarantined_round) == before and entries:
            self.bans.clean(name)
        admitted = self._admit_entries(fuzzer, entries)
        self.gossip_pulled_n += admitted
        return admitted

    def _peer_round(self, fuzzer, reg) -> None:
        self._rounds += 1
        # serve-side bootstrap: a resumed campaign's pre-existing
        # store must be servable before the first admission — and
        # attaching the store lets the sidecar drop every cached
        # buffer the store already holds (metadata-only heap)
        if not self._store_published and fuzzer.store is not None:
            self._store_published = True
            self.sidecar.attach_store(fuzzer.store)
            for e in fuzzer.store.load():
                self.sidecar.publish(e)
        if self._rounds == 1 or \
                self._rounds % self.peer_refresh_rounds == 0 or \
                not self.peers:
            self._refresh_peers()
        candidates = [(w, ep) for w, ep in sorted(self.peers.items())
                      if not self.bans.is_banned(w)]
        picked = (self._rng.sample(candidates,
                                   min(self.fanout, len(candidates)))
                  if candidates else [])
        pulled = 0
        failed_peers = []
        for name, endpoint in picked:
            got = self._pull_peer(fuzzer, name, endpoint)
            if got < 0:
                failed_peers.append(name)
            else:
                pulled += got
        # counters: in/out deltas + round count (fold-able sums)
        reg.count("gossip_rounds")
        if pulled:
            reg.count("gossip_entries_in", pulled)
        served = self.sidecar.served_n
        if served > self._served_seen:
            reg.count("gossip_entries_out",
                      served - self._served_seen)
            self._served_seen = served
        reg.gauge("gossip_peers", len(self.peers))
        reg.gauge("peers_banned_active", len(self.bans.active()))
        if picked:
            fuzzer.telemetry.event(
                "gossip_round", peers=[n for n, _ in picked],
                pulled=int(pulled), failed=failed_peers)

    def _flush_quarantine(self, fuzzer, reg) -> None:
        batch = list(self._quarantined_round)
        super()._flush_quarantine(fuzzer, reg)
        # strike the offenders; threshold crossings ban with
        # decorrelated backoff and land in the event stream
        by_peer: Dict[str, int] = {}
        for _, _, peer in batch:
            if peer is not None:
                by_peer[peer] = by_peer.get(peer, 0) + 1
        for peer, n in sorted(by_peer.items()):
            if self.bans.strike(peer, n):
                reg.count("peers_banned")
                fuzzer.telemetry.event(
                    "peer_banned", peer=peer,
                    until=self.bans.banned_until.get(peer))
        if by_peer:
            reg.gauge("peers_banned_active",
                      len(self.bans.active()))
