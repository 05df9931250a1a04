"""The port's search tier against the JAX package's: the soft-KBVM
gradient (``torch.autograd`` against ``jax.grad``, within 1e-6
relative) and its rounded proposals (equal), the host descent engine
``descend_edge`` and the device engine (``DeviceDescent`` stepped and
in-scan, ``descend_edge_device``) — witnesses, iteration, dispatch and
evaluation counts, elite fronts and witness rings bit for bit — the
descent spans on the flight recorder's ``descent`` lane, and the
``kb-descend`` tool's output.  The engines run on the CPU here
(``device="cpu"``); the card's run is held to the CPU's in
``tests/test_torch_kernels_cuda.py``."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu.analysis.solver import solve_edge as jax_solve_edge
from killerbeez_tpu.models import targets as jax_targets
from killerbeez_tpu.models import targets_cgc as jax_cgc  # noqa: F401
from killerbeez_tpu.models import vm as jax_vm
from killerbeez_tpu.search import descend_edge as jax_descend
from killerbeez_tpu.search import descend_edge_device as jax_descend_dev
from killerbeez_tpu.search import soft as jax_soft
from killerbeez_tpu.search.device_descent import DeviceDescent as JaxDD
from killerbeez_tpu.tools import descend_tool as jax_descend_tool
from killerbeez_tpu_torch.analysis.solver import concrete_run
from killerbeez_tpu_torch.models import targets
from killerbeez_tpu_torch.models.compiler import Assembler
from killerbeez_tpu_torch.search import (
    DeviceDescent, descend_edge, descend_edge_device, edge_objectives,
    seeds_reaching_block, soft, soft_refine, trace_slice,
)
from killerbeez_tpu_torch.search.device_descent import FAM_I2S
from killerbeez_tpu_torch.telemetry.trace import TraceRecorder
from killerbeez_tpu_torch.tools import descend_tool

torch.set_num_threads(1)


def _jax_program(prog):
    return jax_vm.Program(instrs=prog.instrs.copy(), name=prog.name,
                          mem_size=prog.mem_size, max_steps=prog.max_steps)


def _never():
    """Impossible eq (a byte can never be 256): every probe family runs
    for as many iterations as asked."""
    a = Assembler("never")
    a.block()                       # 0
    a.ldi(2, 0)
    a.ldb(1, 2)
    a.ldi(2, 1)
    a.alu("mul", 3, 1, 2)
    a.ldi(2, 256)
    a.br("eq", 3, 2, "win")
    a.block()                       # 1
    a.halt(0)
    a.label("win")
    a.block()                       # 2
    a.halt(0)
    return a.build()


def _arith(cmp="eq", k=3, c=200):
    """r3 = k*input[0] + input[1] - 7; branch <cmp> r3, c."""
    a = Assembler(f"arith_{cmp}")
    a.block()                       # 0
    a.ldi(2, 0)
    a.ldb(1, 2)
    a.ldi(2, k)
    a.alu("mul", 3, 1, 2)
    a.ldi(2, 1)
    a.ldb(1, 2)
    a.alu("add", 3, 3, 1)
    a.addi(3, 3, -7)
    a.load_len(4)
    a.alu("sub", 3, 3, 4)
    a.ldi(2, c)
    a.br(cmp, 3, 2, "win")
    a.block()                       # 1
    a.halt(0)
    a.label("win")
    a.block()                       # 2
    a.halt(0)
    return a.build()


def _pair(name):
    return jax_targets.get_target(name), targets.get_target(name)


# -- the soft-KBVM gradient ---------------------------------------------

SOFT_CASES = [(cmp, data) for cmp in ("eq", "ne", "lt", "ge")
              for data in (b"\x00\x00", b"\x10\x05\x00", b"\xff\x80",
                           b"\x40\x3c")]


@pytest.mark.parametrize("cmp,data", SOFT_CASES,
                         ids=[f"{c}-{d.hex()}" for c, d in SOFT_CASES])
def test_soft_gradient_and_proposals_match_jax(cmp, data):
    prog = _arith(cmp)
    jprog = _jax_program(prog)
    checked = 0
    for edge in ((0, 1), (0, 2)):
        for obj in edge_objectives(prog, edge):
            sl = trace_slice(prog, data, obj)
            jsl = jax_soft.trace_slice(jprog, data, obj)
            assert (sl.steps, sl.eligible, sl.reached) == \
                (jsl.steps, jsl.eligible, jsl.reached)
            if not sl.eligible:
                continue
            g = soft.soft_gradient(prog, sl, obj, data)
            x0 = jnp.asarray(np.frombuffer(data, np.uint8)
                             .astype(np.float32))
            jg = np.asarray(jax.grad(jax_soft._soft_distance(
                jprog, jsl, obj, len(data)))(x0))
            np.testing.assert_allclose(g, jg, rtol=1e-6, atol=0)
            assert soft_refine(prog, data, obj, slice_=sl) == \
                jax_soft.soft_refine(jprog, data, obj, slice_=jsl)
            checked += 1
    assert checked


def test_soft_tier_refuses_bit_ops():
    a = Assembler("bitop")
    a.block()
    a.ldi(2, 0)
    a.ldb(1, 2)
    a.ldi(2, 255)
    a.alu("and", 3, 1, 2)
    a.ldi(2, 77)
    a.br("eq", 3, 2, "win")
    a.block()
    a.halt(0)
    a.label("win")
    a.block()
    a.halt(0)
    prog = a.build()
    obj = edge_objectives(prog, (0, 2))[0]
    sl = trace_slice(prog, b"\x00\x00", obj)
    assert not sl.eligible and "ALU" in sl.reason
    assert soft_refine(prog, b"\x00\x00", obj) == []


# -- the host engine ----------------------------------------------------

def _descend_pair(name, edge, seeds, **kw):
    jprog, prog = _pair(name) if isinstance(name, str) else \
        (_jax_program(name), name)
    ref = jax_descend(jprog, edge, seeds, **kw)
    out = descend_edge(prog, edge, seeds, device="cpu", **kw)
    assert out.as_dict() == ref.as_dict()
    if out.input is not None:
        assert tuple(edge) in concrete_run(prog, out.input).edges
    return out


def test_host_descent_cracks_imgparse_checksum_edge():
    seed = jax_solve_edge(jax_targets.get_target("imgparse_vm"),
                          (11, 13)).input
    res = _descend_pair("imgparse_vm", (13, 14), [seed], lanes=128,
                        budget=12)
    assert res.status == "descended" and res.engine == "host"


def test_host_descent_soft_tier_on_magicsum():
    """Six iterations from a zero seed: the soft tier proposes (its
    gradients overflow float32 on this slice, as in the JAX package),
    and the verdict, distance and counts are the JAX package's."""
    res = _descend_pair("magicsum_vm", (4, 5), [bytes(6)], lanes=128,
                        budget=6)
    assert res.soft_used and res.status == "exhausted"


def test_host_descent_cracks_arith_with_soft_proposals():
    res = _descend_pair(_arith(), (0, 2), [b"\x00\x00"], lanes=64,
                        budget=16)
    assert res.status == "descended"


def test_host_descent_exhausts_honestly():
    res = _descend_pair(_never(), (0, 2), [b"\x00"], lanes=64, budget=4)
    assert res.status == "exhausted" and res.input is None
    assert res.steps == 4 and res.best_dist > 0


def test_host_descent_spans_on_descent_lane():
    prog = targets.get_target("imgparse_vm")
    seed = jax_solve_edge(jax_targets.get_target("imgparse_vm"),
                          (11, 13)).input
    tr = TraceRecorder(max_events=4096)
    descend_edge(prog, (13, 14), [seed], lanes=64, budget=3, trace=tr,
                 device="cpu")
    lane = tr.lane_id("descent")
    spans = [e for e in tr.to_chrome()["traceEvents"]
             if e.get("name") == "descend_batch" and e.get("tid") == lane
             and e.get("ph") == "B"]
    assert spans and all("edge" in s["args"] for s in spans)


def test_seeds_reaching_block_filter():
    prog = targets.get_target("imgparse_vm")
    seed = jax_solve_edge(jax_targets.get_target("imgparse_vm"),
                          (11, 13)).input
    assert seeds_reaching_block(prog, [seed, b"zzz"], 13) == [seed]
    assert len(seeds_reaching_block(prog, [seed, b"zzz"], -1)) == 2


# -- the device engine --------------------------------------------------

def _drive(eng, dispatches):
    wits = []
    for _ in range(dispatches):
        wits.extend(eng.dispatch())
    return (eng.elite_front(), wits, eng.witnesses_total,
            eng.best_primary, eng.it)


def _same_drive(a, b):
    for x, y in zip(a[0], b[0]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert a[1:] == b[1:]


DD_CASES = [("never", (0, 2), [b"\x12\x34\x56"], 8),
            ("magicsum_vm", (4, 5), [bytes(6)], 4),
            ("imgparse_vm", (14, 15), None, 4)]


@pytest.mark.parametrize("name,edge,seeds,R", DD_CASES,
                         ids=[c[0] for c in DD_CASES])
def test_device_descent_stepped_scanned_and_jax_agree(name, edge, seeds,
                                                      R):
    """R one-iteration dispatches == one R-iteration dispatch == the
    JAX package's stepped engine: elite fronts (bufs, lens, stages,
    distances), witness rows, ring totals, best distance."""
    if name == "never":
        prog = _never()
        jprog = _jax_program(prog)
    else:
        jprog, prog = _pair(name)
    if seeds is None:
        seeds = [jax_solve_edge(jprog, (11, 13)).input]
    stepped = _drive(DeviceDescent(prog, edge, seeds, lanes=128,
                                   scan_iters=1, device="cpu"), R)
    scanned = _drive(DeviceDescent(prog, edge, seeds, lanes=128,
                                   scan_iters=R, device="cpu"), 1)
    ref = _drive(JaxDD(jprog, edge, seeds, lanes=128, scan_iters=1), R)
    _same_drive(stepped, scanned)
    _same_drive(stepped, ref)


def test_device_descent_soft_and_focus_refresh_match_jax():
    """The host-side steps between dispatches (focus refresh, soft
    proposals injected into the elite tail) keep both packages in
    step."""
    jprog, prog = _pair("magicsum_vm")
    out = []
    for eng in (DeviceDescent(prog, (2, 4), [b"\x01" * 6], lanes=128,
                              scan_iters=2, i2s=False, device="cpu"),
                JaxDD(jprog, (2, 4), [b"\x01" * 6], lanes=128,
                      scan_iters=2, i2s=False)):
        rows = eng.dispatch()
        eng.refresh_focus()
        n_soft = eng.soft_propose()
        n_inj = eng.inject_candidates([b"\x05\x06", b"", b"\xff" * 9])
        rows += eng.dispatch()
        out.append((rows, n_soft, n_inj, list(eng.pos_order),
                    eng.last_worked, eng.elite_front()))
    a, b = out
    assert a[:5] == b[:5]
    for x, y in zip(a[5], b[5]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [
    dict(lanes=128, budget=4, scan_iters=2),
    dict(lanes=64, budget=12, scan_iters=8),
], ids=["i2s-crack", "tail-dispatch"])
def test_descend_edge_device_matches_jax(kw):
    jprog, prog = _pair("magicsum_vm")
    edge = (4, 5) if kw["budget"] == 4 else (2, 4)
    ref = jax_descend_dev(jprog, edge, [bytes(6)], **kw)
    out = descend_edge_device(prog, edge, [bytes(6)], device="cpu", **kw)
    assert out.as_dict() == ref.as_dict()
    assert out.engine == "device"
    if kw["budget"] == 4:
        assert out.status == "descended" and out.i2s
        assert (4, 5) in concrete_run(prog, out.input).edges


def test_witness_ring_tags_the_i2s_family():
    prog = targets.get_target("magicsum_vm")
    rows = DeviceDescent(prog, (4, 5), [bytes(6)], lanes=128,
                         scan_iters=4, device="cpu").dispatch()
    assert rows and any(fam == FAM_I2S for _, fam, _ in rows)


def test_device_engine_stands_down_on_unconditional_edges():
    a = Assembler("uncond")
    a.block()
    a.ldi(1, 7)
    a.block()
    a.halt(0)
    prog = a.build()
    res = descend_edge_device(prog, (0, 1), [b"\x00"], lanes=64,
                              budget=2, scan_iters=2, device="cpu")
    ref = jax_descend_dev(_jax_program(prog), (0, 1), [b"\x00"],
                          lanes=64, budget=2, scan_iters=2)
    assert res.as_dict() == ref.as_dict()
    assert res.engine == "host" and res.status == "descended"


def test_device_spans_on_descent_lane():
    tr = TraceRecorder(max_events=4096)
    descend_edge_device(_never(), (0, 2), [b"\x00"], lanes=64, budget=4,
                        scan_iters=2, trace=tr, device="cpu")
    lane = tr.lane_id("descent")
    spans = [e for e in tr.to_chrome()["traceEvents"]
             if e.get("name") == "descend_scan" and e.get("tid") == lane
             and e.get("ph") == "B"]
    assert len(spans) == 2
    assert all(s["args"]["scan_iters"] == 2 for s in spans)


def test_engines_ask_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = targets.get_target("magicsum_vm")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        descend_edge(prog, (4, 5), [bytes(6)], budget=1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        DeviceDescent(prog, (4, 5), [bytes(6)])


# -- kb-descend -----------------------------------------------------------

def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv", [
    ["magicsum_vm", "--lanes", "128", "--budget", "8", "--json",
     "--edge", "4:5"],
    ["magicsum_vm", "--lanes", "64", "--budget", "3", "--engine", "host",
     "--rounds", "1"],
    ["magicsum_vm", "--lanes", "64", "--budget", "2", "--block", "4",
     "--require-cracked", "5"],
    ["test"],
], ids=["device-json", "host-text", "require-gate", "nothing-unknown"])
def test_kb_descend_matches_jax(argv):
    ref = _run(jax_descend_tool.main, argv)
    out = _run(descend_tool.main, argv + ["--device", "cpu"])
    assert out == ref
