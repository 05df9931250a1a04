"""At a tiny size on the CPU, the benchmark's reference agrees with the
port's plain path bit for bit: the frozen program, the PRNG, havoc,
the VM, triage and the ``-G`` loop."""

import json

import numpy as np
import pytest
import torch

from kbbench import spec
from reference import generations as ref_gen
from reference import havoc, prng, triage, vm

from killerbeez_tpu_torch.models import targets as kt
from killerbeez_tpu_torch.models.vm import _run_batch_impl
from killerbeez_tpu_torch.ops import generations as kg
from killerbeez_tpu_torch.ops import prng as kp
from killerbeez_tpu_torch.ops.mutate_core import havoc_at
from killerbeez_tpu_torch.ops.static_triage import make_static_maps, \
    static_triage
from killerbeez_tpu_torch.ops.vm_kernel import havoc_words_for_keys

M32 = 0xFFFFFFFF
PROGRAMS = {"tlvstack": "tlvstack_vm"}


def _config(name):
    with open(spec.bench_path(f"configs/{name}.json"),
              encoding="utf-8") as f:
        return json.load(f)


@pytest.mark.parametrize("cfg", sorted(PROGRAMS))
def test_frozen_program_is_the_ports_target(cfg):
    c = _config(cfg)
    ref = vm.load_program(str(spec.bench_path(c["program"])))
    port = kt.get_target(PROGRAMS[cfg])
    assert ref.name == port.name
    assert np.array_equal(ref.instrs, port.instrs)
    assert np.array_equal(ref.edge_table, port.edge_table)
    assert np.array_equal(ref.edge_slot, port.edge_slot)
    assert (ref.mem_size, ref.max_steps, ref.map_size) == \
        (port.mem_size, port.max_steps, port.map_size)


def test_frozen_seeds():
    from killerbeez_tpu_torch.models import targets_cgc
    assert bytes.fromhex(_config("tlvstack")["seed_hex"]) == \
        targets_cgc.tlvstack_vm_seed()


def _lanes(seed_hex, n, it0=1234, mut_seed=2**31 + 77):
    seed = bytes.fromhex(seed_hex)
    L = max(-(-len(seed) * 2 // 8) * 8, 8)
    buf = torch.zeros(L, dtype=torch.uint8)
    buf[:len(seed)] = torch.tensor(list(seed), dtype=torch.uint8)
    its = (it0 + torch.arange(n, dtype=torch.int64)) & M32
    return seed, buf, its, mut_seed


def test_prng_and_havoc():
    seed, buf, its, ms = _lanes(_config("tlvstack")["seed_hex"], 257)
    words = prng.havoc_words(prng.key(ms), its, 4)
    port_words = havoc_words_for_keys(kp.fold_in(kp.key(ms), its), 4)
    assert torch.equal(words & M32, port_words.to(torch.int64) & M32)
    got = havoc.havoc(buf, len(seed), words, 4)
    want = havoc_at(buf, len(seed), port_words, 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _mutants(cfg, n):
    seed, buf, its, ms = _lanes(_config(cfg)["seed_hex"], n)
    return havoc.havoc(buf, len(seed),
                       prng.havoc_words(prng.key(ms), its, 4), 4)


@pytest.mark.parametrize("max_steps", [0, 64])
def test_vm_and_triage(max_steps):
    c = _config("tlvstack")
    prog = vm.load_program(str(spec.bench_path(c["program"])))
    bufs, lens = _mutants("tlvstack", 192)
    got = vm.run(prog, bufs, lens, max_steps)
    want = _run_batch_impl(torch.as_tensor(prog.instrs),
                           torch.as_tensor(prog.edge_table), bufs, lens,
                           prog.mem_size, max_steps or prog.max_steps,
                           prog.n_edges)
    for f in ("status", "exit_code", "counts", "steps", "path_hash"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    # a budget of 64 steps leaves lanes running: the hang verdict
    assert bool((got.status == vm.FUZZ_RUNNING).any()) == bool(max_steps)
    us, seg = triage.static_maps(prog.edge_slot)
    pus, pseg = make_static_maps(prog.edge_slot)
    st = torch.where(got.status == vm.FUZZ_RUNNING, vm.FUZZ_HANG,
                     got.status)
    maps = [torch.full((prog.map_size,), 0xFF, dtype=torch.uint8)
            for _ in range(3)]
    for half in (slice(0, 96), slice(96, 192)):
        r = triage.triage(*maps, got.counts[half], torch.as_tensor(us),
                          torch.as_tensor(seg), st[half] == vm.FUZZ_CRASH,
                          st[half] == vm.FUZZ_HANG)
        p = static_triage(*maps, got.counts[half], torch.as_tensor(pus),
                          torch.as_tensor(pseg), st[half] == vm.FUZZ_CRASH,
                          st[half] == vm.FUZZ_HANG)
        for a, b in zip(r, p):
            assert torch.equal(a, b)
        maps = list(r[3:])
    assert (maps[0] != 0xFF).any()


def test_generations_dispatch():
    c = _config("tlvstack")
    prog = vm.load_program(str(spec.bench_path(c["program"])))
    port = kt.get_target("tlvstack_vm")
    seed, buf, _its, ms = _lanes(c["seed_hex"], 1)
    n, g, adm, F, it0, gen0 = 64, 3, 4, 256, 640, 5
    ring = kg.new_ring(buf, len(seed), 8)
    maps = [torch.full((prog.map_size,), 0xFF, dtype=torch.uint8)
            for _ in range(3)]
    us, seg = triage.static_maps(prog.edge_slot)
    ref_ring = {"bufs": ring.bufs[:8].clone(), "lens": ring.lens[:8].clone(),
                "filled": ring.filled[:8].clone(),
                "hits": ring.hits[:8].clone(),
                "finds": ring.finds[:8].clone(), "ptr": ring.ptr.clone()}
    rep, ring2, maps2, _pg = ref_gen.run(
        prog, ref_ring, tuple(m.clone() for m in maps), prng.key(ms), it0,
        n, gen0, ms & M32, g, adm, F, 4, torch.as_tensor(us),
        torch.as_tensor(seg))
    pus, pseg = make_static_maps(port.edge_slot)
    its0 = (it0 + torch.arange(n, dtype=torch.int64)) & M32
    (vb, vc, vh, _vs), pring, prep = kg.run_generations(
        torch.as_tensor(port.instrs), torch.as_tensor(port.edge_table),
        torch.as_tensor(pus), torch.as_tensor(pseg), ring, kp.key(ms), its0,
        n, gen0, ms & M32, *maps, mem_size=port.mem_size,
        max_steps=port.max_steps, n_edges=port.n_edges, exact=False,
        stack_pow2=4, g=g, adm_cap=adm, findings_cap=F)
    out = kg.GenerationOutcome(*prep, gen0=gen0, g=g, n_real=n, cap=F)
    assert int(out.fr_ptr) == rep["fr_ptr"] > 0
    assert out.sel.tolist() == rep["sel"]
    assert out.adm_raw.tolist() == rep["adm_raw"]
    for k in ("fr_pack", "fr_gen", "fr_iter", "fr_len", "fr_bufs",
              "adm_valid", "adm_slot", "adm_iter", "adm_len", "adm_bufs",
              "ring_filled"):
        assert torch.equal(getattr(out, k).to(torch.int64),
                           rep[k].to(torch.int64)), k
    for k in ("bufs", "lens", "filled", "hits", "finds"):
        assert torch.equal(getattr(pring, k)[:8], ring2[k]), k
    assert int(pring.ptr) == int(ring2["ptr"])
    for a, b in zip((vb, vc, vh), maps2):
        assert torch.equal(a, b)
