"""The check fails what it must, at a tiny size on the CPU.

The control (the reference in the program's place with one of the
configuration's guarantees broken) comes out ``correct`` false through
the same comparison where the program comes out true; and a whole run
of the harness, with the timed path broken underneath it, comes out
``correct`` false for each fault a cell can have: a step that returns its state unchanged, half of the
batch left out, an answer altered where it is produced.  (No cell
spans chips, so none can leave out an exchange between them.)"""

import pytest
import torch

from kbbench import main as bench

from killerbeez_tpu_torch.instrumentation import jit_harness
from killerbeez_tpu_torch.ops import generations

#: one cell of each check kind (``tlvstack.fb0`` shares the superbatch
#: check with ``tlvstack.fb``)
CELLS = ["tlvstack.fb", "tlvstack.gen16"]
TINY = {"lanes": 32, "warmup_steps": 1}


def _fused(instr):
    instr.engine = "cuda_fused"     # the plain versions, on the CPU


def _run(cell, seed, control=False):
    return bench.run_cell(cell, seed, 1.0, False, device="cpu",
                          prepare=lambda f: _fused(
                              f.driver.instrumentation),
                          log=lambda s: None, control=control,
                          tiny=TINY)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(cell):
    res = _run(cell, 2**31 + 11, control=True)
    assert res["correct"]
    assert all(v["value"] == 0 for v in res["checks"].values())
    ctl = res["control"]
    assert not ctl["correct"], ctl
    assert max(v["value"] for v in ctl["checks"].values()) > 0


def _rows(res, keep):
    """A VM result with the lanes outside ``keep`` zeroed."""
    return type(res)(*(None if t is None else torch.where(
        keep.reshape(-1, *[1] * (t.dim() - 1)), t, torch.zeros_like(t))
        for t in res))


def _half(res):
    b = res.status.shape[0]
    return _rows(res, torch.arange(b) < b // 2)


def _altered(res):
    status = res.status.clone()
    status[0] = status[0] ^ 2           # none <-> crash
    return res._replace(status=status)


def _patch_vm(monkeypatch, fault):
    for mod in (jit_harness, generations):
        fn = mod.fuzz_batch_2phase

        def broken(*a, _fn=fn, **k):
            res, bufs, lens = _fn(*a, **k)
            return fault(res), bufs, lens
        monkeypatch.setattr(mod, "fuzz_batch_2phase", broken)


def _state_unchanged(monkeypatch):
    counts = jit_harness._triage_counts

    def frozen(c, st, us, seg, vb, vc, vh, exact):
        return counts(c, st, us, seg, vb, vc, vh, exact)[:3] + (vb, vc, vh)
    monkeypatch.setattr(jit_harness, "_triage_counts", frozen)


FAULTS = {
    "state_unchanged": _state_unchanged,
    "half_batch": lambda mp: _patch_vm(mp, _half),
    "answer_altered": lambda mp: _patch_vm(mp, _altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    res = _run(cell, 2**31 + 23)
    assert not res["correct"], res["checks"]
