"""Proxy registry: declarative native⇄KBVM bindings + certification.

A :class:`ProxyBinding` ties a native target (argv / stdin / file /
TCP driver spec — the reference's driver layer, PAPER.md L2) to the
soft-KBVM proxy program the device tier fuzzes in its place.  ``bind()``
runs a CERTIFICATION check first: the binding's benign seed must
behave identically on both sides (same FUZZ verdict class).  A
binding that fails certification is refused — a proxy that diverges
on a benign input would make every cross-tier verdict meaningless.

Certification uses a BENIGN seed on purpose: a proxy that diverges
only on crashing inputs still binds, and that divergence surfaces
later as a ``proxy_only`` verdict plus a machine-readable proxy-gap
report — the signal for improving the proxy, never a silent drop
(docs/HYBRID.md).

When the native toolchain is absent, certification returns a
skip-with-reason record (``certified: None``) instead of failing:
the stand-down rule is "no native tier, no hybrid claims".

The built-in bindings' native binaries are the port's own corpus
fixtures, built with make into ``build/torch_native/corpus/`` on first
use (``native/build.py``).  The proxy side runs on the caller's device:
on the card a verdict is one launch of ``kbz_vm_kernel`` over a
one-lane batch, on the CPU its plain version.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .. import FUZZ_CRASH, FUZZ_HANG, FUZZ_NONE, FUZZ_RUNNING
from ..native import build as _native_build
from .translate import DELIVERY_MODES, NativeDelivery, to_delivery

#: where the built-in bindings' fixture binaries live: the port's own
#: corpus build (built there on first use), unless KB_CORPUS_BUILD_DIR
#: names a directory of binaries built elsewhere
CORPUS_BUILD_DIR = os.environ.get("KB_CORPUS_BUILD_DIR",
                                  _native_build.CORPUS_BUILD_DIR)


class CertificationError(ValueError):
    """A binding's benign seed behaves differently on proxy vs
    native — the binding is refused."""


@dataclass
class NativeSpec:
    """How to run the native side of a binding (driver spec)."""

    argv: Tuple[str, ...]
    #: one of translate.DELIVERY_MODES
    delivery: str = "stdin"
    #: file mode: the input path to pass (exec_backend substitutes)
    input_file: Optional[str] = None
    #: train modes: the framed-sequence message cap (m_max)
    m_max: int = 0
    #: tcp mode: (host, port) the launched server listens on
    addr: Optional[Tuple[str, int]] = None
    timeout: float = 2.0
    env: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        self.argv = tuple(self.argv)
        if self.delivery not in DELIVERY_MODES:
            raise ValueError(
                f"unknown delivery {self.delivery!r} "
                f"(choose from {', '.join(DELIVERY_MODES)})")
        if self.delivery in ("stdin_train", "tcp") and self.m_max <= 0:
            raise ValueError(
                f"delivery {self.delivery!r} needs m_max > 0")
        # a spec that ExecTarget cannot actually deliver must be
        # refused HERE: running the binary without its payload makes
        # every genuinely-crashing finding classify as proxy_only
        if self.delivery == "argv":
            raise ValueError(
                "delivery 'argv' has no native runner yet (translate "
                "supports it; ExecTarget does not substitute argv "
                "payloads) — use stdin or file")
        if self.delivery == "file" and not self.input_file:
            raise ValueError(
                "delivery 'file' needs input_file (the path "
                "exec_backend rewrites before each run)")


@dataclass
class ProxyBinding:
    """One native target and its soft-KBVM proxy."""

    name: str
    #: built-in KBVM target name (models/targets.py registry)
    proxy_target: str
    native: NativeSpec
    #: certification input: must be verdict-identical on both sides
    benign_seed: bytes = b"hello"
    #: crash reproducers that must ALSO be verdict-identical at bind
    #: time — () for deliberately-divergent fixtures like test_safe,
    #: where crash divergence is the point, not a wiring bug.  These
    #: double as the repair pass's certification obligations: a patch
    #: that "fixes" a gap by breaking a known-good reproducer is
    #: rejected (analysis/repair.py honesty contract).
    crash_seeds: Tuple[bytes, ...] = ()
    #: when set, the proxy program loads from this .npz instead of the
    #: target registry — how a kb-repair patched proxy installs
    #: without code changes
    program_file: Optional[str] = None

    def program(self):
        if self.program_file:
            from ..models.targets import load_program_file
            return load_program_file(self.program_file)
        from ..models.targets import get_target
        return get_target(self.proxy_target)

    def translate(self, buf: bytes) -> NativeDelivery:
        return to_delivery(buf, self.native.delivery,
                           self.native.m_max)


# -- registry ---------------------------------------------------------

_BINDINGS: Dict[str, ProxyBinding] = {}


def register_binding(binding: ProxyBinding) -> ProxyBinding:
    _BINDINGS[binding.name] = binding
    return binding


def get_binding(name: str) -> ProxyBinding:
    _ensure_builtins()
    try:
        return _BINDINGS[name]
    except KeyError:
        raise KeyError(
            f"unknown proxy binding {name!r} (choose from "
            f"{', '.join(sorted(_BINDINGS)) or '<none>'})")


def binding_names() -> List[str]:
    _ensure_builtins()
    return sorted(_BINDINGS)


_BUILTINS_DONE = False


def _ensure_builtins() -> None:
    global _BUILTINS_DONE
    if _BUILTINS_DONE:
        return
    _BUILTINS_DONE = True
    for b in builtin_bindings():
        _BINDINGS.setdefault(b.name, b)


def builtin_bindings() -> List[ProxyBinding]:
    """The shipped proxy⇄native pairs (corpus/ fixtures).

    * ``test`` — the KBVM "test" target and its native twin
      ``corpus/test.c`` (both crash on inputs starting "ABCD"): the
      faithful pair, every device-tier finding should confirm.
    * ``test_safe`` — the same proxy bound to ``corpus/hybrid_safe.c``
      (reads input, always exits 0): the DELIBERATELY DIVERGENT pair
      — benign certification passes, crashes never reproduce, every
      crash verdict is ``proxy_only``.  Exists to exercise the
      proxy-gap path end to end.
    """
    d = CORPUS_BUILD_DIR
    return [
        ProxyBinding(
            name="test", proxy_target="test",
            native=NativeSpec(argv=(os.path.join(d, "test-plain"),),
                              delivery="stdin"),
            benign_seed=b"hello",
            crash_seeds=(b"ABCD",)),
        ProxyBinding(
            name="test_safe", proxy_target="test",
            native=NativeSpec(argv=(os.path.join(d, "hybrid-safe"),),
                              delivery="stdin"),
            benign_seed=b"hello"),
    ]


# -- execution (both sides) -------------------------------------------

def proxy_verdict(binding: ProxyBinding, buf: bytes,
                  device="cuda") -> int:
    """Run one input through the soft-KBVM proxy on ``device``; returns
    the FUZZ_* verdict with the step-budget lane mapped to FUZZ_HANG
    (the engine's wait-loop-timeout convention).  The input is a
    one-lane batch for ``ops/vm_kernel.run_batch``: ``kbz_vm_kernel``
    over every lane on the card, the plain VM on the CPU."""
    import torch

    from .. import resolve_device
    from ..ops import vm_kernel

    dev = resolve_device(device)
    program = binding.program()
    buf = bytes(buf)
    inputs = torch.tensor([list(buf or b"\x00")], dtype=torch.uint8,
                          device=dev)
    lengths = torch.tensor([len(buf)], dtype=torch.int32, device=dev)
    out = vm_kernel.run_batch(
        torch.as_tensor(program.instrs, device=dev),
        torch.as_tensor(program.edge_table, device=dev), inputs, lengths,
        program.mem_size, program.max_steps, program.n_edges)
    status = int(out.status[0])
    return FUZZ_HANG if status == FUZZ_RUNNING else status


def ensure_native_binary(exe: str) -> None:
    """Build a binding's binary on first use when it is one of the
    port's own corpus fixtures (``build/torch_native/corpus/<name>``);
    other paths are left as they are.  Raises RuntimeError with make's
    output when the build fails."""
    if not os.path.exists(exe) and os.path.dirname(
            os.path.abspath(exe)) == _native_build.CORPUS_BUILD_DIR:
        _native_build.build_corpus([os.path.basename(exe)])


def open_native(spec: NativeSpec):
    """Build an ExecTarget for the binding's native side (launch-style
    for tcp).  Callers own close()."""
    from ..native.exec_backend import ExecTarget

    ensure_native_binary(spec.argv[0])

    kwargs: Dict[str, Any] = dict(
        timeout=spec.timeout,
        extra_env=([f"{k}={v}" for k, v in spec.env.items()]
                   if spec.env else None),
    )
    if spec.delivery in ("stdin", "stdin_train"):
        kwargs["use_stdin"] = True
    elif spec.delivery == "file":
        kwargs["input_file"] = spec.input_file
    return ExecTarget(list(spec.argv), **kwargs)


def native_verdict(target, spec: NativeSpec,
                   delivery: NativeDelivery) -> Tuple[int, int]:
    """Replay one delivery on the native side; returns
    ``(FUZZ_* verdict, raw status)``."""
    from ..native.exec_backend import classify, replay_message_train

    if spec.delivery in ("stdin_train", "tcp"):
        status = replay_message_train(
            target, delivery.messages or [delivery.payload],
            mode=spec.delivery, addr=spec.addr,
            timeout=spec.timeout)
    else:
        status = target.run(delivery.payload, spec.timeout)
    kind, _ = classify(status)
    return kind, status


# -- certification ----------------------------------------------------

def _verdict_class(kind: int) -> str:
    if kind == FUZZ_CRASH:
        return "crash"
    if kind == FUZZ_HANG:
        return "hang"
    if kind == FUZZ_NONE:
        return "ok"
    return "error"


def certify_binding(binding: ProxyBinding,
                    device="cuda") -> Dict[str, Any]:
    """Run the binding's benign seed through both sides (the proxy on
    ``device``) and compare verdict classes.  Returns a certification record::

        {"certified": True | False | None, "reason": ...,
         "proxy": {"verdict": ...}, "native": {"verdict": ..., ...}}

    ``None`` means the native substrate is unavailable (toolchain
    absent / binary missing) — skip-with-reason, never a silent
    pass."""
    from ..native.build import build_error, native_available

    if not native_available():
        return {"certified": None, "binding": binding.name,
                "reason": f"native toolchain unavailable: "
                          f"{build_error()}"}
    exe = binding.native.argv[0]
    try:
        ensure_native_binary(exe)
    except RuntimeError as e:
        return {"certified": None, "binding": binding.name,
                "reason": f"native binary build failed: {e}"}
    if not os.path.exists(exe):
        return {"certified": None, "binding": binding.name,
                "reason": f"native binary missing: {exe} "
                          f"(make -C corpus)"}
    target = open_native(binding.native)
    seeds = [("benign", binding.benign_seed)]
    seeds += [(f"crash[{i}]", s)
              for i, s in enumerate(binding.crash_seeds)]
    try:
        for label, seed in seeds:
            p_kind = proxy_verdict(binding, seed, device)
            delivery = binding.translate(seed)
            n_kind, n_status = native_verdict(
                target, binding.native, delivery)
            p_cls, n_cls = _verdict_class(p_kind), \
                _verdict_class(n_kind)
            if p_cls != n_cls:
                return {
                    "certified": False, "binding": binding.name,
                    "reason": f"{label} seed diverges: proxy={p_cls} "
                              f"native={n_cls}",
                    "proxy": {"target": binding.proxy_target,
                              "verdict": p_cls},
                    "native": {"argv": list(binding.native.argv),
                               "delivery": binding.native.delivery,
                               "verdict": n_cls,
                               "status": n_status},
                }
    finally:
        target.close()
    return {
        "certified": True, "binding": binding.name, "reason": None,
        "seeds": len(seeds),
        "proxy": {"target": binding.proxy_target, "verdict": p_cls},
        "native": {"argv": list(binding.native.argv),
                   "delivery": binding.native.delivery,
                   "verdict": n_cls, "status": n_status},
    }


def install_repaired(base: ProxyBinding, program_path: str,
                     certify: bool = True,
                     device="cuda") -> ProxyBinding:
    """Register ``<base.name>+repaired``: the same native side bound
    to a kb-repair patched proxy program (.npz).

    RE-certification is mandatory by default — a patched proxy gets
    no grandfather rights from the binding it repairs.  When the
    native substrate is unavailable the install is refused (None
    certification is a skip, and a skipped check cannot admit a
    program whose whole provenance is "I changed the semantics")."""
    import dataclasses

    repaired = dataclasses.replace(
        base, name=f"{base.name}+repaired",
        program_file=os.path.abspath(program_path))
    if certify:
        cert = certify_binding(repaired, device)
        if cert["certified"] is not True:
            raise CertificationError(
                f"repaired binding {repaired.name!r} refused: "
                f"{cert['reason'] or 'native tier unavailable'}")
    return register_binding(repaired)


def bind(binding: ProxyBinding, certify: bool = True,
         strict: bool = True, device="cuda") -> Dict[str, Any]:
    """Register a binding, certification first.  ``strict`` refuses
    a binding whose benign seed diverges (CertificationError); an
    unavailable native substrate registers anyway with the skip
    reason in the record (the bridge will stand down at attach)."""
    cert: Dict[str, Any] = {"certified": None,
                            "reason": "certification skipped"}
    if certify:
        cert = certify_binding(binding, device)
        if strict and cert["certified"] is False:
            raise CertificationError(
                f"binding {binding.name!r} refused: {cert['reason']}")
    register_binding(binding)
    return cert
