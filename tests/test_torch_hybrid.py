"""The port's hybrid bridge (``killerbeez_tpu_torch/hybrid/``), its
corpus hooks and the ``--auto-repair`` stage against the JAX package's,
on the CPU, the counterparts of ``tests/test_hybrid.py`` and of the
store and repairer cases of ``tests/test_conformance.py``:

  * ``translate``: ``from_delivery(to_delivery(buf)) == buf`` in every
    delivery mode, and both packages' deliveries equal (hypothesis,
    derandomized);
  * ``gaps``: the same reports into both packages' ``GapIndex`` (dedup,
    cap eviction, torn-manifest rebuild) give the same index and files,
    and the same holds for the repair ledger;
  * ``registry``: ``certify_binding`` records on ``test``, ``test_safe``
    and a miswired binding, and ``proxy_verdict`` (the port on the CPU:
    the plain version of ``kbz_vm_kernel``) on 256 seeded inputs,
    ``ABCD``, ``hello`` and inputs that run out of steps;
  * ``validate``: a scripted native side (statuses per attempt, with
    ``FUZZ_ERROR`` retries) gives the same verdicts in both
    ``NativeValidator``s, and a stub fuzzer driving both
    ``HybridBridge.fold``s gets the same sidecars, events, counters,
    store validation blocks and scheduler credit;
  * the store: ``kb-corpus compact`` without ``--dry-run`` removes the
    same md5s from both stores, ``update_validation`` and
    ``update_repair`` accept and refuse the same blocks, and both
    ``EntryValidator``s agree on repair blocks;
  * ``ProxyRepairer``: it fires only at a plateau with new gaps, and its
    ledger and corpus write-back match the JAX stage's.

The JAX side's native binaries come from the ``corpus_bin`` fixture, the
port's from its own build (``build/torch_native/corpus/``); records are
compared with wall-clock fields dropped and native argv reduced to the
binary's name.  Tolerance: none."""

import base64
import json
import os
import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import killerbeez_tpu.hybrid.registry as jax_registry
from killerbeez_tpu.corpus.quarantine import EntryValidator as JaxValidator
from killerbeez_tpu.corpus.schedule import Arm as JaxArm
from killerbeez_tpu.corpus.schedule import make_scheduler as jax_scheduler
from killerbeez_tpu.corpus.store import CorpusEntry as JaxEntry
from killerbeez_tpu.corpus.store import CorpusStore as JaxStore
from killerbeez_tpu.corpus.store import coverage_hash
from killerbeez_tpu.fuzzer.repairer import ProxyRepairer as JaxRepairer
from killerbeez_tpu.hybrid import gaps as jax_gaps
from killerbeez_tpu.hybrid import translate as jax_translate
from killerbeez_tpu.hybrid import validate as jax_validate
from killerbeez_tpu.telemetry import MetricsRegistry as JaxRegistry
from killerbeez_tpu.tools import corpus_tool as jax_corpus_tool
from killerbeez_tpu_torch import FUZZ_CRASH, FUZZ_ERROR, FUZZ_HANG, FUZZ_NONE
from killerbeez_tpu_torch.corpus.quarantine import EntryValidator
from killerbeez_tpu_torch.corpus.schedule import Arm, make_scheduler
from killerbeez_tpu_torch.corpus.store import CorpusEntry, CorpusStore
from killerbeez_tpu_torch.fuzzer.repairer import ProxyRepairer
from killerbeez_tpu_torch.hybrid import gaps, registry, translate, validate
from killerbeez_tpu_torch.native import build
from killerbeez_tpu_torch.stateful.framing import frame_messages
from killerbeez_tpu_torch.telemetry import MetricsRegistry
from killerbeez_tpu_torch.tools import corpus_tool
from killerbeez_tpu_torch.utils.fileio import md5_hex

torch.set_num_threads(1)

M_MAX = 4
#: wall-clock fields, dropped before records are compared
CLOCK = ("t", "ts", "wall_s", "seconds", "discovered")

#: each package's modules, by name
PKGS = {
    "jax": dict(gaps=jax_gaps, registry=jax_registry,
                translate=jax_translate, validate=jax_validate,
                Store=JaxStore, Entry=JaxEntry, Arm=JaxArm,
                scheduler=jax_scheduler, Registry=JaxRegistry,
                Repairer=JaxRepairer, Validator=JaxValidator,
                corpus_tool=jax_corpus_tool),
    "torch": dict(gaps=gaps, registry=registry, translate=translate,
                  validate=validate, Store=CorpusStore, Entry=CorpusEntry,
                  Arm=Arm, scheduler=make_scheduler,
                  Registry=MetricsRegistry, Repairer=ProxyRepairer,
                  Validator=EntryValidator, corpus_tool=corpus_tool),
}


def _norm(obj, root=None):
    """``obj`` without wall-clock fields, native argv reduced to the
    binary's name, ``root`` made relative."""
    if isinstance(obj, dict):
        return {k: ([os.path.basename(a) for a in v] if k == "argv"
                    else _norm(v, root))
                for k, v in obj.items() if k not in CLOCK}
    if isinstance(obj, (list, tuple)):
        return [_norm(v, root) for v in obj]
    if isinstance(obj, str) and root is not None:
        return obj.replace(str(root), "<root>")
    return obj


def _dir(path, root):
    """Every file of a directory: JSON parsed and normalized."""
    out = {}
    for name in sorted(os.listdir(path)) if os.path.isdir(path) else []:
        with open(os.path.join(path, name), "rb") as f:
            raw = f.read()
        out[name] = _norm(json.loads(raw), root) \
            if name.endswith(".json") else raw
    return out


@pytest.fixture(scope="module")
def port_bin():
    try:
        build.build_corpus(["test-plain", "hybrid-safe"])
    except RuntimeError as e:
        pytest.skip(f"native build unavailable: {e}")


# -- translate -----------------------------------------------------------


def _delivery(d):
    return (d.mode, d.raw, d.payload, d.messages)


@settings(derandomize=True, max_examples=60, deadline=None)
@given(buf=st.binary(max_size=96),
       mode=st.sampled_from(translate.DELIVERY_MODES))
def test_translate_roundtrip_matches_jax(buf, mode):
    m_max = M_MAX if mode in translate.TRAIN_MODES else 0
    d = translate.to_delivery(buf, mode, m_max)
    jd = jax_translate.to_delivery(buf, mode, m_max)
    assert _delivery(d) == _delivery(jd)
    assert translate.from_delivery(d, m_max) == buf
    # a train re-encoded canonically is a fixpoint in both packages
    if mode in translate.TRAIN_MODES:
        canon = translate.train_to_buffer(d.messages, m_max)
        assert canon == jax_translate.train_to_buffer(d.messages, m_max)
        assert translate.buffer_to_train(canon, m_max) == d.messages


def test_translate_native_built_and_refusals_match_jax():
    msgs = [b"ab", b"", b"c"]
    for mod in (translate, jax_translate):
        d = mod.NativeDelivery("stdin_train", payload=b"".join(msgs),
                               messages=msgs)
        assert mod.from_delivery(d, m_max=M_MAX) == frame_messages(
            msgs, M_MAX)
        for bad in (("stdin_train", 0), ("bogus", 0)):
            with pytest.raises(ValueError) as e:
                mod.to_delivery(b"x", *bad)
            assert "m_max" in str(e.value) or "unknown" in str(e.value)


# -- gaps ----------------------------------------------------------------


def _report(mod, buf, *, t, kind="crash", edge=(1, 2)):
    return mod.make_gap_report(
        md5=md5_hex(buf), kind=kind, binding="test_safe",
        proxy_target="test", proxy_status=FUZZ_CRASH,
        native_argv=["hybrid-safe"], native_delivery="stdin",
        statuses=[0, 0, 0], repro=0, repeats=3, t=t, input_bytes=buf,
        edge=edge)


def test_gap_index_and_ledger_match_jax(tmp_path):
    """Dedup (same edge, kind and md5), a distinct kind of the same
    input, cap eviction (cap 3, files removed), an oversized input, a
    torn and then a missing manifest, and the ledger's cap and torn
    file: the same returns, index and files in both packages."""
    bufs = [bytes([i]) * 4 for i in range(5)]
    got = {}
    for pkg, p in PKGS.items():
        d = str(tmp_path / pkg)
        mod = p["gaps"]
        idx = mod.GapIndex(d, cap=3)
        rets = []
        for i, buf in enumerate(bufs):
            rets.append(idx.admit(_report(mod, buf, t=float(i))))
        rets.append(idx.admit(_report(mod, bufs[4], t=9.0)))
        rets.append(idx.admit(_report(mod, bufs[4], t=9.0, kind="hang")))
        big = mod.make_gap_report(
            md5="b" * 32, kind="crash", binding="test", proxy_target="test",
            proxy_status=FUZZ_CRASH, native_argv=["x"],
            native_delivery="stdin", statuses=[], repro=0, repeats=0,
            t=10.0, input_bytes=b"x" * ((1 << 16) + 1))
        rets.append(idx.admit(big))
        files = _dir(d, d)
        (tmp_path / pkg / "index.json").write_text("{torn")
        torn = mod.GapIndex(d).entries
        (tmp_path / pkg / "index.json").unlink()
        rebuilt = mod.GapIndex(d).entries
        for i in range(5):
            mod.append_ledger(d, {"status": "repaired", "i": i}, cap=3)
        ledger = mod.load_ledger(d)
        (tmp_path / pkg / "repairs.json").write_text("not json")
        got[pkg] = ([r and os.path.relpath(r, d) for r in rets],
                    idx.evicted, idx.duplicates, files, torn, rebuilt,
                    ledger, mod.load_ledger(d))
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == 4 and got["torch"][2] == 1


# -- registry ------------------------------------------------------------


def _bindings(mod, native_dir):
    """The built-ins with each package's binaries, and the miswired
    binding whose benign seed crashes the proxy only."""
    test = mod.ProxyBinding(
        name="test", proxy_target="test",
        native=mod.NativeSpec(argv=(os.path.join(native_dir, "test-plain"),)),
        benign_seed=b"hello", crash_seeds=(b"ABCD",))
    safe = mod.ProxyBinding(
        name="test_safe", proxy_target="test",
        native=mod.NativeSpec(argv=(os.path.join(native_dir,
                                                 "hybrid-safe"),)),
        benign_seed=b"hello")
    broken = mod.ProxyBinding(name="broken", proxy_target="test",
                              native=safe.native, benign_seed=b"ABCD")
    return test, safe, broken


def test_builtin_bindings_point_at_the_port_build():
    for b in registry.builtin_bindings():
        assert os.path.dirname(b.native.argv[0]) == registry.CORPUS_BUILD_DIR
    assert registry.CORPUS_BUILD_DIR == build.CORPUS_BUILD_DIR


def test_certify_records_match_jax(corpus_bin, port_bin):
    jax_b = _bindings(jax_registry, os.path.dirname(corpus_bin("test")))
    port_b = _bindings(registry, build.CORPUS_BUILD_DIR)
    for jb, pb in zip(jax_b, port_b):
        jrec = jax_registry.certify_binding(jb)
        rec = registry.certify_binding(pb, device="cpu")
        assert _norm(rec) == _norm(jrec), pb.name
    assert [registry.certify_binding(b, device="cpu")["certified"]
            for b in port_b] == [True, True, False]
    with pytest.raises(registry.CertificationError):
        registry.bind(port_b[2], device="cpu")
    # the built-ins certify through the registry itself
    for name in ("test", "test_safe"):
        assert registry.certify_binding(registry.get_binding(name),
                                        device="cpu")["certified"] is True


def _verdict_inputs():
    rng = np.random.default_rng(13)
    bufs = [b"ABCD", b"hello", b""]
    for i in range(256):
        n = int(rng.choice([1, 4, 6, 8]))
        x = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        if i % 2:       # half reach the nested byte checks
            x = (b"ABCD"[:int(rng.integers(0, 5))] + x)[:n]
        bufs.append(x)
    return bufs


def test_proxy_verdict_matches_jax():
    """256 seeded inputs with ``ABCD`` and ``hello`` on ``test``, and
    inputs that run out of steps on the ``hang`` target (FUZZ_RUNNING
    is reported as FUZZ_HANG)."""
    test = registry.get_binding("test")
    jtest = jax_registry.get_binding("test")
    bufs = _verdict_inputs()
    got = [registry.proxy_verdict(test, b, device="cpu") for b in bufs]
    assert got == [jax_registry.proxy_verdict(jtest, b) for b in bufs]
    assert {FUZZ_CRASH, FUZZ_NONE} <= set(got)
    hang, jhang = (mod.ProxyBinding(name="spin", proxy_target="hang",
                                    native=mod.NativeSpec(argv=("x",)))
                   for mod in (registry, jax_registry))
    spins = [b"H", b"Hzz", b"h", b"xH"]
    got = [registry.proxy_verdict(hang, b, device="cpu") for b in spins]
    assert got == [jax_registry.proxy_verdict(jhang, b) for b in spins]
    assert got[:2] == [FUZZ_HANG, FUZZ_HANG]


def test_proxy_verdict_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        registry.proxy_verdict(registry.get_binding("test"), b"ABCD")


# -- validate ------------------------------------------------------------

#: scripted native statuses per attempt, and the finding's kind
SCRIPTS = [
    ([FUZZ_CRASH] * 3, "crash", 3),
    ([FUZZ_NONE] * 3, "crash", 3),
    ([FUZZ_CRASH, FUZZ_NONE, FUZZ_CRASH], "crash", 3),
    ([FUZZ_HANG] * 3, "hang", 3),
    ([FUZZ_CRASH] * 3, "hang", 3),
    ([FUZZ_ERROR, FUZZ_ERROR, FUZZ_CRASH, FUZZ_CRASH, FUZZ_CRASH],
     "crash", 3),
    ([FUZZ_ERROR] * 8, "crash", 2),
    ([FUZZ_CRASH] * 64, "crash", 1000),
]


def _scripted(mod, statuses, kind, repeats):
    it = iter(statuses)
    sleeps = []
    binding = mod["registry"].ProxyBinding(
        name="fake", proxy_target="test",
        native=mod["registry"].NativeSpec(argv=("/bin/true",)))
    v = mod["validate"].NativeValidator(
        binding, repeats=repeats, run_fn=lambda buf: next(it),
        sleep_fn=sleeps.append)
    rec = v.validate(mod["validate"].ValidationItem(
        kind, b"X", md5_hex(b"X")))
    return _norm(rec), sleeps


@pytest.mark.parametrize("statuses,kind,repeats", SCRIPTS)
def test_native_validator_verdicts_match_jax(statuses, kind, repeats):
    got = _scripted(PKGS["torch"], statuses, kind, repeats)
    assert got == _scripted(PKGS["jax"], statuses, kind, repeats)


class _Telemetry:
    def __init__(self, registry_cls):
        self.registry = registry_cls()
        self.events = []

    def event(self, etype, **fields):
        self.events.append({"type": etype, **fields})


class _StubFuzzer:
    PIPELINE_DEPTH = 0

    def __init__(self, p, out, store=None):
        self.telemetry = _Telemetry(p["Registry"])
        self.output_dir = str(out)
        self.write_findings = True
        self.store = store
        self.scheduler = p["scheduler"]("bandit")
        self.stats = type("Stats", (), {"new_paths": 0, "iterations": 0})()
        self.batch_size = 1


def _fold(p, out):
    """test_hybrid.py's fold case: a confirming finding that is also a
    corpus entry (generated by an arm in rotation), a diverging one, a
    duplicate enqueue and a hang, through enqueue -> pump -> fold."""
    os.makedirs(out / "crashes")
    os.makedirs(out / "hangs")
    store = p["Store"](str(out / "corpus"))
    fz = _StubFuzzer(p, out, store)
    parent = p["Arm"](b"GENERATOR")
    fz.scheduler.admit(parent)
    crash, gap, hang = b"CRASH", b"NOPE", b"SPIN"
    store.put(p["Entry"](crash, sig=[9]))
    verdicts = {crash: FUZZ_CRASH, gap: FUZZ_NONE, hang: FUZZ_HANG}
    binding = p["registry"].ProxyBinding(
        name="fake", proxy_target="test",
        native=p["registry"].NativeSpec(argv=("/bin/true",)))
    bridge = p["validate"].HybridBridge(
        binding, workers=0, validator=p["validate"].NativeValidator(
            binding, repeats=3, run_fn=verdicts.__getitem__))
    rets = [bridge.enqueue("crash", crash, md5_hex(crash),
                           parent=parent.md5),
            bridge.enqueue("crash", gap, md5_hex(gap)),
            bridge.enqueue("crash", crash, md5_hex(crash)),
            bridge.enqueue("hang", hang, md5_hex(hang),
                           proxy_status=FUZZ_HANG)]
    rets += [bridge.pump(), bridge.fold(fz)]
    snap = fz.telemetry.registry.snapshot()
    return {"rets": rets,
            "events": _norm(fz.telemetry.events, out),
            "counters": {k: v for k, v in snap["counters"].items()
                         if k.startswith("hybrid_")},
            "gauges": {k: v for k, v in snap["gauges"].items()
                       if k.startswith("validation_")},
            "findings": {k: _dir(out / k, out)
                         for k in ("crashes", "hangs", "proxy_gaps")},
            "store": {e.md5: e.validation for e in store.load()},
            "credit": [list(a[1:3]) for a in fz.scheduler.arms],
            "confirmed": sorted(fz.scheduler.confirmed_md5s),
            "snapshot": bridge.snapshot()}


def test_bridge_fold_matches_jax(tmp_path):
    got = {pkg: _fold(p, tmp_path / pkg) for pkg, p in PKGS.items()}
    got = {pkg: {k: _norm(v, tmp_path / pkg) for k, v in g.items()}
           for pkg, g in got.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"]["counters"] == {
        "hybrid_validations": 3, "hybrid_confirmed": 2,
        "hybrid_proxy_only": 1, "hybrid_proxy_gaps": 1}
    assert got["torch"]["credit"] == [[0.0, 1.0]]


def test_bridge_queue_full_drop_and_finish_match_jax(tmp_path):
    """A full queue rejects and counts; the dropped finding stays
    eligible; finish() drains without workers and folds."""
    got = {}
    for pkg, p in PKGS.items():
        binding = p["registry"].ProxyBinding(
            name="fake", proxy_target="test",
            native=p["registry"].NativeSpec(argv=("/bin/true",)))
        bridge = p["validate"].HybridBridge(
            binding, workers=0, queue_cap=1,
            validator=p["validate"].NativeValidator(
                binding, run_fn=lambda buf: FUZZ_CRASH))
        rets = [bridge.enqueue("crash", b, md5_hex(b)) for b in (b"A", b"B")]
        rets.append(bridge.pump())
        rets += [bridge.enqueue("crash", b, md5_hex(b)) for b in (b"B", b"A")]
        os.makedirs(tmp_path / pkg / "crashes")
        fz = _StubFuzzer(p, tmp_path / pkg)
        bridge.finish(fz)
        got[pkg] = (rets, bridge.queue.dropped, bridge.enqueued,
                    bridge.validated, fz.telemetry.registry.snapshot()
                    ["counters"])
    assert got["torch"] == got["jax"]
    assert got["torch"][:4] == ([True, False, 1, True, False], 1, 2, 2)


# -- the store -----------------------------------------------------------


def test_compact_removes_the_same_entries_as_jax(tmp_path):
    """``kb-corpus compact`` without ``--dry-run``: the entry whose edges
    the other covers is removed from the store, in both packages."""
    got = {}
    for pkg, p in PKGS.items():
        store = p["Store"](str(tmp_path / pkg))
        for buf, sig in ((b"WIDE", [1, 2, 3]), (b"NARROW", [2, 3]),
                         (b"UNSIGNED", None)):
            store.put(p["Entry"](buf, sig=sig))
        assert len(store) == 3
        removed = p["corpus_tool"].compact(store, store.load())
        got[pkg] = (removed, sorted(os.listdir(tmp_path / pkg)), len(store))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [md5_hex(b"NARROW")]
    assert got["torch"][2] == 2


def test_update_validation_and_repair_match_jax(tmp_path):
    rep = {"verdict": "repaired", "patch": "const-nudge@pc22",
           "reason": None, "t": 5.0}
    val = {"verdict": "proxy_only", "repro": 0, "repeats": 3}
    got = {}
    for pkg, p in PKGS.items():
        store = p["Store"](str(tmp_path / pkg))
        e = p["Entry"](b"GAPPY", sig=[4])
        store.put(e)
        rets = [store.update_repair(e.md5, rep),
                store.update_validation(e.md5, val),
                store.update_repair(e.md5, rep),
                store.update_repair("f" * 32, rep),
                store.update_validation("f" * 32, val)]
        got[pkg] = (rets, _dir(tmp_path / pkg, tmp_path / pkg),
                    [x.validation for x in store.load()])
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [False, True, True, False, False]


def _repair_row(buf, repair):
    meta = {"sig": [1], "md5": md5_hex(buf),
            "cov_hash": coverage_hash([1], buf), "seq": 0,
            "source": "local", "tier": "native",
            "validation": {"verdict": "proxy_only", "repro": 0,
                           "repeats": 3, "repair": repair}}
    return {"worker": "w", "md5": md5_hex(buf),
            "cov_hash": coverage_hash([1], buf),
            "content_b64": base64.b64encode(buf).decode(), "meta": meta}


@pytest.mark.parametrize("repair", [
    {"verdict": "unrepairable", "patch": None,
     "reason": "patch:space-exhausted", "t": 9.0},
    "repaired", {"verdict": "probably"}, {"verdict": "repaired", "t": "noon"},
    {"verdict": "repaired", "patch": "p" * 257},
    {"verdict": "repaired", "reason": ["x"]},
])
def test_entry_validator_repair_blocks_match_jax(repair):
    entry, reason = EntryValidator().validate(_repair_row(b"DATA", repair))
    jentry, jreason = JaxValidator().validate(_repair_row(b"DATA", repair))
    assert reason == jreason
    assert (entry is None) == (jentry is None)
    if entry is not None:
        assert entry.validation == jentry.validation


# -- the scheduler -------------------------------------------------------


def test_note_validation_matches_jax():
    got = {}
    for pkg, p in PKGS.items():
        s = p["scheduler"]("bandit")
        parent, child, other = (p["Arm"](b) for b in
                                (b"PARENT", b"CHILD", b"OTHER"))
        for a in (parent, child, other):
            s.admit(a)
        s.note_validation(child.md5, "confirmed", parent=parent.md5)
        s.note_validation(child.md5, "confirmed", parent=parent.md5)
        s.note_validation(other.md5, "proxy_only")
        s.note_validation(other.md5, "flaky")
        got[pkg] = ([list(a[1:3]) for a in s.arms],
                    s.state_dict().get("confirmed"),
                    (s.CONFIRM_CREDIT, s.CONFIRM_CAP))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [[0.0, 1.0], [0.0, 1.0], [0.0, 0.0]]


# -- the --auto-repair stage ---------------------------------------------


class _StubBridge:
    def __init__(self, binding, gaps=0):
        self.binding = binding
        self.proxy_gaps = gaps


def _gap_corpus(p, out):
    """test_conformance.py's three counterexamples of test_safe."""
    program = p["registry"].get_binding("test_safe").program()
    idx = p["gaps"].GapIndex(str(out / "proxy_gaps"))
    for buf in (b"ABCD", b"ABCDxx", b"ABCD\x00\x01"):
        idx.admit(_report(p["gaps"], buf, t=1.0, edge=p["gaps"]
                          .proxy_trace_edge(program, buf)))


def _plateau(p, out):
    binding = p["registry"].get_binding("test_safe")
    _gap_corpus(p, out)
    fz = _StubFuzzer(p, out)
    bridge = _StubBridge(binding, gaps=3)
    rep = p["Repairer"](bridge, plateau_batches=4, apply=False)
    trail = []
    for i in range(10):                  # progress: never fires
        fz.stats.iterations = fz.stats.new_paths = i
        rep.maybe_repair(fz)
    trail.append(rep.attempts)
    for step in (3, 10, 10):             # inside, past, past again
        fz.stats.iterations += step
        rep.maybe_repair(fz)
        trail.append((rep.attempts, rep.last_status))
    bridge.proxy_gaps += 1               # the gap set grew
    rep.finish(fz)
    trail.append(rep.attempts)
    return trail, _norm(fz.telemetry.events), \
        fz.telemetry.registry.snapshot()["counters"]


def test_repairer_plateau_trigger_matches_jax(tmp_path):
    got = {pkg: _plateau(p, tmp_path / pkg) for pkg, p in PKGS.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [0, (0, None), (1, "repaired"),
                               (1, "repaired"), 2]


def test_repairer_write_back_matches_jax(tmp_path, monkeypatch):
    """A repaired verdict lands in the ledger and in the corpus entry's
    validation block; the install (re-certification on the native
    binary) is the campaign tests' job, stubbed here in both."""
    monkeypatch.setattr(jax_registry, "install_repaired",
                        lambda base, path, certify=True: base)
    monkeypatch.setattr(registry, "install_repaired",
                        lambda base, path, certify=True, device="cuda": base)
    got = {}
    for pkg, p in PKGS.items():
        out = tmp_path / pkg
        store = p["Store"](str(out / "corpus"))
        e = p["Entry"](b"ABCD", sig=[2])
        store.put(e)
        store.update_validation(e.md5, {"verdict": "proxy_only",
                                        "repro": 0, "repeats": 3})
        _gap_corpus(p, out)
        fz = _StubFuzzer(p, out, store=store)
        rep = p["Repairer"](_StubBridge(
            p["registry"].get_binding("test_safe"), gaps=3), apply=True)
        result = rep.repair(fz)
        got[pkg] = _norm({"result": result,
                          "ledger": p["gaps"].load_ledger(
                              str(out / "proxy_gaps")),
                          "store": [x.validation for x in store.load()],
                          "events": fz.telemetry.events}, out)
    assert got["torch"] == got["jax"]
    assert got["torch"]["result"]["status"] == "repaired"
    assert got["torch"]["store"][0]["repair"]["verdict"] == "repaired"


def test_bridge_worker_threads_validate_everything():
    """workers=2: each native worker owns its validator; every queued
    finding is validated off-thread and folds on the caller."""
    binding = registry.ProxyBinding(
        name="fake", proxy_target="test",
        native=registry.NativeSpec(argv=("/bin/true",)))
    bridge = validate.HybridBridge(
        binding, workers=2, validator_factory=lambda: validate.NativeValidator(
            binding, repeats=2, run_fn=lambda buf: FUZZ_CRASH))
    assert len({id(v) for v in bridge._worker_validators}
               | {id(bridge.validator)}) == 3
    rng = random.Random(3)
    bufs = {bytes(rng.randrange(256) for _ in range(6)) for _ in range(8)}
    for b in bufs:
        bridge.enqueue("crash", b, md5_hex(b))
    fz = _StubFuzzer(PKGS["torch"], "unused")
    fz.write_findings = False
    bridge._write_finding_sidecar = lambda *a: None
    bridge.finish(fz, drain_timeout=10.0)
    c = fz.telemetry.registry.snapshot()["counters"]
    assert c["hybrid_validations"] == c["hybrid_confirmed"] == len(bufs)
