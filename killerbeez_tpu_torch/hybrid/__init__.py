"""Hybrid native⇄device campaign bridge (docs/HYBRID.md).

The device tier explores cheap soft-KBVM proxies at millions of execs
per second on the card, native workers confirm its findings on the
real binary, and both tiers share one corpus, event and fleet stream.
The pieces:

  * :mod:`.registry`  — declarative proxy⇄native bindings with a
    bind-time certification check (the benign seed behaves alike on
    both sides; the proxy's verdict is one ``kbz_vm_kernel`` launch on
    the card, its plain version on the CPU);
  * :mod:`.translate` — lossless seed translation between the device
    tier's byte buffers and native delivery formats (stdin, file,
    argv, framed TCP/stdin message trains);
  * :mod:`.validate`  — the cross-tier triage pipeline: bounded
    validation queue, native replay with retry/backoff, ``confirmed``
    / ``proxy_only`` / ``flaky`` verdicts, proxy-gap reports;
  * :mod:`.reconcile` — per-tier coverage reconciliation: tier tags
    on entries / heartbeats / gossip rows, per-tier fleet folds, the
    native-tier heartbeat;
  * :mod:`.gaps`      — bounded, deduped, indexed storage for
    proxy-gap reports: the conformance/repair pass's counterexample
    queue (analysis/conformance.py, analysis/repair.py).
"""

from .gaps import (  # noqa: F401
    GAP_SCHEMA,
    GapIndex,
    append_ledger,
    load_ledger,
    make_gap_report,
)
from .registry import (  # noqa: F401
    CertificationError,
    NativeSpec,
    ProxyBinding,
    bind,
    binding_names,
    builtin_bindings,
    certify_binding,
    get_binding,
    install_repaired,
    register_binding,
)
from .translate import (  # noqa: F401
    NativeDelivery,
    from_delivery,
    to_delivery,
)
from .validate import (  # noqa: F401
    VERDICT_CONFIRMED,
    VERDICT_FLAKY,
    VERDICT_PROXY_ONLY,
    HybridBridge,
    NativeValidator,
    ValidationQueue,
    make_bridge,
)
from .reconcile import (  # noqa: F401
    DEFAULT_TIER,
    NativeHeartbeat,
    tier_of,
)
