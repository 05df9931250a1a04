"""The plateau auto-repair stage — counterexample-guided proxy
repair inside a running hybrid campaign (``--auto-repair``).

The crack stage (crack.py) spends plateaus extending COVERAGE; this
stage spends them repairing CONFORMANCE: when the loop plateaus and
the hybrid bridge has accumulated NEW proxy-gap reports since the
last attempt, run the bounded repair pass (analysis/repair.py) over
``<output>/proxy_gaps/``.  A verified patch is saved as a loadable
``.npz``, registered as ``<binding>+repaired`` after mandatory
native re-certification, written to the repair ledger (the
conformance lint's consumed-set), and folded back into the gap
entries' corpus sidecars.  An ``unrepairable`` verdict is recorded
just as loudly — counters, event, ledger — never retried in a hot
loop (each attempt re-arms only when the gap set GROWS).

The running campaign keeps fuzzing the ORIGINAL proxy either way:
swapping programs mid-flight would invalidate the coverage map, the
scheduler's arms and every cached trace.  The repaired binding is
for the NEXT campaign — which is why the install is registry-level
and the artifact lands on disk.  The re-certification runs the proxy
on the campaign's device (``device``).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

from ..utils.logging import INFO_MSG, WARNING_MSG


class ProxyRepairer:
    """Owns the plateau trigger and the repair-attempt bookkeeping
    for ONE hybrid campaign."""

    def __init__(self, bridge, *, plateau_batches: int = 16,
                 apply: bool = True, device="cuda"):
        self.bridge = bridge
        #: where install_repaired's re-certification runs the proxy
        self.device = device
        self.plateau_batches = max(int(plateau_batches), 1)
        #: save + install + ledger on a repaired verdict (tests turn
        #: this off to keep the registry pristine)
        self.apply = bool(apply)
        self.attempts = 0
        self.last_status: Optional[str] = None
        self._last_new_paths = -1
        self._progress_iter = 0
        #: bridge.proxy_gaps at the last attempt: re-arm only when
        #: the counterexample set GROWS (an unrepairable verdict on
        #: the same evidence would just repeat)
        self._gaps_at_attempt = 0

    # -- the plateau trigger (the cracker's padded-window discipline) --

    def maybe_repair(self, fuzzer) -> None:
        s = fuzzer.stats
        if s.new_paths != self._last_new_paths:
            self._last_new_paths = s.new_paths
            self._progress_iter = s.iterations
            return
        depth = getattr(fuzzer, "PIPELINE_DEPTH", 0)
        window = (self.plateau_batches + depth) * fuzzer.batch_size
        if s.iterations - self._progress_iter < window:
            return
        self._progress_iter = s.iterations      # re-arm the window
        if self.bridge.proxy_gaps <= self._gaps_at_attempt:
            return          # no new counterexamples since last try
        self.repair(fuzzer)

    def finish(self, fuzzer) -> None:
        """Run-end attempt: gaps that accumulated after the last
        plateau still get consumed (called after bridge.finish(), so
        the queue is drained and every verdict has folded)."""
        if self.bridge.proxy_gaps > self._gaps_at_attempt:
            self.repair(fuzzer)

    # -- the repair itself ---------------------------------------------

    def repair(self, fuzzer) -> Optional[Dict[str, Any]]:
        """One bounded repair pass; returns the kbz-proxy-repair-v1
        result (None when the pass itself failed)."""
        from ..analysis.repair import (
            run_repair, save_patched_program, write_repair_ledger,
        )

        gaps_dir = os.path.join(fuzzer.output_dir, "proxy_gaps")
        self._gaps_at_attempt = self.bridge.proxy_gaps
        self.attempts += 1
        reg = fuzzer.telemetry.registry
        reg.count("repair_attempts")
        t0 = time.time()
        try:
            result, patched = run_repair(self.bridge.binding,
                                         gaps_dir)
        except Exception as e:      # repair must never kill the loop
            WARNING_MSG("proxy repair pass died: %s", e)
            reg.count("repair_errors")
            return None
        status = result["status"]
        self.last_status = status
        if status == "repaired":
            reg.count("repair_repaired")
        elif status == "unrepairable":
            reg.count("repair_unrepairable")
        if self.apply and status != "no-gaps":
            write_repair_ledger(gaps_dir, result)
        if status == "repaired" and patched is not None \
                and self.apply:
            out = os.path.join(
                gaps_dir, f"repaired_{self.bridge.binding.name}.npz")
            try:
                save_patched_program(patched, out)
                result["program_file"] = out
                from ..hybrid.registry import (
                    CertificationError, install_repaired,
                )
                try:
                    installed = install_repaired(
                        self.bridge.binding, out, device=self.device)
                    result["installed"] = installed.name
                except CertificationError as e:
                    # the honesty contract survives the hot loop: a
                    # patch native re-certification refuses is not a
                    # repair
                    result["status"] = status = "unrepairable"
                    result["reason"] = f"recertify:{e}"
                    reg.count("repair_unrepairable")
            except OSError as e:
                WARNING_MSG("patched proxy save failed: %s", e)
        # corpus write-back: the consumed gap entries' sidecars gain
        # validation.repair (gossip-validated by EntryValidator)
        if fuzzer.store is not None and status != "no-gaps":
            rec_t = result.get("t")
            for crec in result.get("clusters") or []:
                rec = {"verdict": crec.get("status"),
                       "patch": (crec.get("patch_desc")
                                 if crec.get("status") == "repaired"
                                 else None),
                       "reason": crec.get("reason"), "t": rec_t}
                for md5 in crec.get("inputs") or []:
                    fuzzer.store.update_repair(md5, rec)
        fuzzer.telemetry.event(
            "proxy_repair", binding=self.bridge.binding.name,
            status=status, reason=result.get("reason"),
            clusters=len(result.get("clusters") or []),
            installed=result.get("installed"),
            seconds=round(time.time() - t0, 3))
        INFO_MSG("proxy repair for binding %r: %s%s (%.2fs)",
                 self.bridge.binding.name, status,
                 f" ({result.get('reason')})"
                 if result.get("reason") else "",
                 time.time() - t0)
        return result
