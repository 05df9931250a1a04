"""The CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no interpret mode, so these tests need a CUDA card:
they carry the ``device`` marker and skip without one (the CPU tier
holds the plain versions to the JAX package instead).  On a machine
with a card: ``python -m pytest tests/test_torch_kernels_cuda.py -q``.
"""

import pytest
import torch

from killerbeez_tpu_torch.models import targets_cgc
from killerbeez_tpu_torch.models.targets import get_target
from killerbeez_tpu_torch.ops import prng
from killerbeez_tpu_torch.ops import vm_kernel as vk

pytestmark = pytest.mark.device

TARGETS = ["test", "hang", "libtest", "tlvstack_vm", "imgparse_vm",
           "rledec_vm", "fixedform_vm"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _setup(name, dev, B=2048, L=64):
    prog = get_target(name)
    fn = targets_cgc.VM_SEEDS.get(name)
    sb = fn[0]() if fn else b"ABC@"
    seed = torch.zeros(L, dtype=torch.uint8, device=dev)
    seed[:len(sb)] = torch.tensor(list(sb), dtype=torch.uint8)
    its = torch.arange(500, 500 + B, dtype=torch.int64, device=dev)
    return (prog, torch.as_tensor(prog.instrs, device=dev),
            torch.as_tensor(prog.edge_table, device=dev), seed, len(sb),
            prng.key(3, device=dev), its)


def _equal(a, b):
    for x, y in zip(a, b):
        if x is None and y is None:     # no edge stream on either side
            continue
        assert torch.equal(x.to(torch.int64).cpu(),
                           y.to(torch.int64).cpu())


@pytest.mark.parametrize("name", TARGETS)
def test_fuzz_kernel_matches_plain(name, cuda):
    L = 128 if name == "fixedform_vm" else 64
    prog, instrs, table, seed, n, key, its = _setup(name, cuda, L=L)
    for steps in (prog.max_steps, 16):
        args = (instrs, table, *vk.seed_ring(seed, n), key, its,
                prog.mem_size, steps, prog.n_edges, 4)
        res, bufs, lens = vk.fuzz_batch(*args)
        ref, rbufs, rlens = vk.fuzz_batch_plain(*args)
        _equal(list(res) + [bufs, lens], list(ref) + [rbufs, rlens])


@pytest.mark.parametrize("sel", [0, 3])
def test_fuzz_kernel_ring_form_matches_plain(sel, cuda):
    """The seed as row ``sel`` of a ring of six random rows, its length
    (30) below L = 64, read by the kernel on the device."""
    prog, instrs, table, seed, n, key, its = _setup("tlvstack_vm", cuda)
    gen = torch.Generator().manual_seed(40 + sel)
    ring = torch.randint(0, 256, (6, 64), dtype=torch.uint8, generator=gen)
    lens = torch.randint(1, 64, (6,), dtype=torch.int32, generator=gen)
    ring, lens = ring.to(cuda), lens.to(cuda)
    ring[sel] = seed
    lens[sel] = n
    sel_t = torch.tensor(sel, dtype=torch.int32, device=cuda)
    for steps in (prog.max_steps, 16):
        args = (instrs, table, ring, lens, sel_t, key, its, prog.mem_size,
                steps, prog.n_edges, 4)
        got = vk.fuzz_batch(*args)
        ref = vk.fuzz_batch_plain(*args)
        _equal(list(got[0]) + list(got[1:]), list(ref[0]) + list(ref[1:]))
        # the same seed given alone: the same lanes
        one = vk.fuzz_batch(instrs, table, *vk.seed_ring(seed, n), key, its,
                            prog.mem_size, steps, prog.n_edges, 4)
        _equal(list(one[0]) + list(one[1:]), list(got[0]) + list(got[1:]))


@pytest.mark.parametrize("name", TARGETS)
def test_vm_kernel_matches_plain(name, cuda):
    L = 128 if name == "fixedform_vm" else 64
    prog, instrs, table, seed, n, key, its = _setup(name, cuda, L=L)
    _, bufs, lens = vk.fuzz_batch(instrs, table, *vk.seed_ring(seed, n),
                                  key, its, prog.mem_size, 1, prog.n_edges,
                                  4)
    _both_kernels(instrs, table, bufs, lens, prog.mem_size,
                  prog.max_steps, prog.n_edges, cuda)


def _both_kernels(instrs, table, bufs, lens, mem_size, max_steps, n_edges,
                  dev):
    """kbz_vm_kernel without and with a lane list against the plain VM;
    returns whether its lanes' state was in shared memory."""
    args = (instrs, table, bufs, lens, mem_size, max_steps, n_edges)
    _equal(vk.run_batch(*args), vk.run_batch_plain(*args))
    lanes, n_lanes = vk.compact_lanes(
        torch.rand(bufs.shape[0], device=dev) < 0.3)
    _equal(vk.run_batch(*args, lanes=lanes, n_lanes=n_lanes),
           vk.run_batch_plain(*args, lanes=lanes, n_lanes=n_lanes))
    return vk.LAST_CONFIG["kbz_vm_kernel"]["lane_state_shared"]


@pytest.mark.parametrize("shape", ["L4096", "edges8000"])
def test_lane_state_in_device_memory(shape, cuda):
    """Inputs of 4096 bytes, or 8000 edges: the lanes' buffers or counts
    rows do not fit shared memory, so both kernels keep them in device
    memory, and stay bit-identical to the plain versions."""
    L, n_edges = (4096, None) if shape == "L4096" else (64, 8000)
    prog, instrs, table, seed, n, key, its = _setup("tlvstack_vm", cuda,
                                                    L=L)
    n_edges = n_edges or prog.n_edges
    args = (instrs, table, *vk.seed_ring(seed, n), key, its, prog.mem_size,
            prog.max_steps, n_edges, 4)
    res, bufs, lens = vk.fuzz_batch(*args)
    assert not vk.LAST_CONFIG["kbz_fuzz_kernel"]["lane_state_shared"]
    ref, rbufs, rlens = vk.fuzz_batch_plain(*args)
    _equal(list(res) + [bufs, lens], list(ref) + [rbufs, rlens])
    assert not _both_kernels(instrs, table, bufs, lens, prog.mem_size,
                             prog.max_steps, n_edges, cuda)


def test_instructions_and_table_in_device_memory(cuda, monkeypatch):
    """With a shared-memory cap below both tables, both kernels read the
    instructions and the edge table from device memory."""
    monkeypatch.setattr(vk, "TABLE_SMEM_MAX", 1024)
    prog, instrs, table, seed, n, key, its = _setup("tlvstack_vm", cuda)
    lay = vk.program_layout(instrs, table, prog.n_edges, cuda)
    assert lay.table_mode == vk.TABLE_DEVICE and not lay.instrs_shared
    args = (instrs, table, *vk.seed_ring(seed, n), key, its, prog.mem_size,
            prog.max_steps, prog.n_edges, 4)
    res, bufs, lens = vk.fuzz_batch(*args)
    ref, rbufs, rlens = vk.fuzz_batch_plain(*args)
    _equal(list(res) + [bufs, lens], list(ref) + [rbufs, rlens])
    assert _both_kernels(instrs, table, bufs, lens, prog.mem_size,
                         prog.max_steps, prog.n_edges, cuda)


def test_fixedform_takes_the_device_memory_table(cuda):
    """fixedform_vm's edge table is too large for shared memory: the
    kernels read it from device memory (and tlvstack_vm's is staged)."""
    for name, mode in (("fixedform_vm", vk.TABLE_DEVICE),
                       ("tlvstack_vm", vk.TABLE_U8)):
        prog = get_target(name)
        lay = vk.program_layout(torch.as_tensor(prog.instrs),
                                torch.as_tensor(prog.edge_table),
                                prog.n_edges, cuda)
        assert lay.table_mode == mode


def test_fused_dispatch_never_waits_for_the_card(cuda, monkeypatch):
    """A superbatch dispatch, and the start of its results' host
    copies, only enqueue work: nothing in them waits for the card (a
    host sync raises under sync debug mode "error"), so the loop keeps
    its pipeline of batches in flight.  Nor does it draw havoc words
    (``prng.bits``): the fused kernel computes each lane's own."""
    from killerbeez_tpu_torch.drivers.factory import driver_factory
    from killerbeez_tpu_torch.ops.host_copy import HostCopy
    from killerbeez_tpu_torch.instrumentation.jit_harness import (
        JitHarnessInstrumentation,
    )
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator

    instr = JitHarnessInstrumentation(
        '{"target": "tlvstack_vm", "engine": "cuda_fused", '
        '"novelty": "throughput"}')
    mut = HavocMutator('{"seed": 3}', targets_cgc.tlvstack_vm_seed())
    drv = driver_factory("file", None, instr, mut)

    def dispatch():
        packed, _bufs, _lens, compact = drv.test_batch_fused_multi(2048, 2)
        return [HostCopy(t) for t in (packed, *compact)]

    dispatch()                   # first use: the kernel build, allocations
    torch.cuda.synchronize()
    bits_calls = []
    real_bits = prng.bits

    def counting_bits(*args, **kwargs):
        bits_calls.append(args)
        return real_bits(*args, **kwargs)
    monkeypatch.setattr(prng, "bits", counting_bits)
    torch.cuda.set_sync_debug_mode("error")
    try:
        copies = dispatch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert copies[0].materialize().shape == (2, 2048)
    assert mut.iteration == 4 * 2048
    # the fused kernel drew every lane's havoc words itself
    assert bits_calls == []


def test_rotation_never_waits_for_the_card(cuda, tmp_path):
    """Corpus feedback at -fb 8 over four rotation boundaries (rr: the
    base seed, then admitted arms): each seed swap uploads through
    pinned staging with a non-blocking copy, and nothing at a boundary
    waits for the card (a host sync raises under sync debug mode
    "error"; the loop's only waits are the CUDA events of its host
    copies, which that mode does not count)."""
    from killerbeez_tpu_torch.drivers.factory import driver_factory
    from killerbeez_tpu_torch.fuzzer.loop import Fuzzer
    from killerbeez_tpu_torch.instrumentation.jit_harness import (
        JitHarnessInstrumentation,
    )
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator

    instr = JitHarnessInstrumentation(
        '{"target": "tlvstack_vm", "engine": "cuda_fused", '
        '"novelty": "throughput"}')
    mut = HavocMutator('{"seed": 3}', targets_cgc.tlvstack_vm_seed())
    width = mut.max_length
    drv = driver_factory("file", None, instr, mut)
    fz = Fuzzer(drv, output_dir=str(tmp_path), batch_size=2048,
                feedback=8, scheduler="rr")
    fz.run(8 * 2048)       # first use: the kernel build, allocations
    torch.cuda.synchronize()
    assert fz.scheduler.arms and fz.scheduler.rotations == 0
    seeds = set()
    real_set_input = mut.set_input

    def set_input(buf, keep_length=False):
        seeds.add(bytes(buf))
        real_set_input(buf, keep_length)
    mut.set_input = set_input
    torch.cuda.set_sync_debug_mode("error")
    try:
        fz.run(40 * 2048)    # to 40 batches: boundaries after 8, 16, 24, 32
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert fz.scheduler.rotations == 4
    assert len(seeds) >= 2 and mut.max_length == width
    assert mut.iteration == 40 * 2048


def test_generations_dispatch_never_waits_for_the_card(cuda):
    """A -G 4 dispatch (four generations, each picking its seed slot on
    the card, the fused kernel reading it from the device ring, triage,
    the findings-ring append and the ring admission) and the start of
    its report's host copies only enqueue work: nothing waits for the
    card (a host sync raises under sync debug mode "error")."""
    from killerbeez_tpu_torch.drivers.factory import driver_factory
    from killerbeez_tpu_torch.instrumentation.jit_harness import (
        JitHarnessInstrumentation,
    )
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator

    instr = JitHarnessInstrumentation(
        '{"target": "tlvstack_vm", "engine": "cuda_fused", '
        '"novelty": "throughput"}')
    mut = HavocMutator('{"seed": 3}', targets_cgc.tlvstack_vm_seed())
    drv = driver_factory("file", None, instr, mut)
    # first use: the kernel build, allocations; the ring fills
    drv.test_batch_generations(2048, 4, pad_to=2048).materialize()
    torch.cuda.synchronize()
    before = dict(vk.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = drv.test_batch_generations(2000, 4, pad_to=2048).prefetch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    h = out.materialize()
    assert h.g == 4 and h.gen0 == 4 and h.n_real == 2000
    assert vk.LAUNCHES["kbz_fuzz_kernel"] == before["kbz_fuzz_kernel"] + 4
    assert vk.LAUNCHES["kbz_vm_kernel"] == before["kbz_vm_kernel"] + 4
    assert int(h.ring_filled.sum()) > 1 and int(h.fr_ptr) > 0
    assert mut.iteration == 2048 * 4 + 2000 * 4


def test_generations_refuse_admissions_past_the_ring(cuda):
    """On the card an admission cap above the ring's S - 1 slots would
    leave either of two lanes in a repeated slot: the dispatch refuses
    it before enqueueing anything; S - 1 runs and fills the ring."""
    from killerbeez_tpu_torch.instrumentation.jit_harness import (
        JitHarnessInstrumentation,
    )
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator
    from killerbeez_tpu_torch.ops.generations import new_ring, \
        run_generations

    instr = JitHarnessInstrumentation(
        '{"target": "cgc_like", "engine": "cuda_fused", '
        '"novelty": "throughput"}')
    mut = HavocMutator('{"seed": 11}', b"CG\x02\x04\x05\x41xx")
    seed_buf, seed_len, base_key, sp = mut.fused_spec()
    p = instr.program

    def dispatch(adm_cap):
        ring = new_ring(seed_buf.to(cuda), seed_len, 8)
        return run_generations(
            instr._instrs, instr._edge_table, instr._u_slots,
            instr._seg_id, ring, base_key.to(cuda),
            instr._its(mut.peek_iterations(2048)), 2048, 0, 0,
            instr.virgin_bits, instr.virgin_crash, instr.virgin_tmout,
            mem_size=p.mem_size, max_steps=p.max_steps, n_edges=p.n_edges,
            exact=False, stack_pow2=int(sp), g=4, adm_cap=adm_cap,
            findings_cap=256)

    before = dict(vk.LAUNCHES)
    with pytest.raises(ValueError, match="exceeds the ring's 7 "
                       "admission slots"):
        dispatch(8)
    assert vk.LAUNCHES == before
    _, ring, _ = dispatch(7)
    assert int(ring.filled[:ring.slots].sum()) > 1


def test_stream_engine_on_the_card_equals_the_cpu(cuda):
    """The stream-recording plain engine on CUDA tensors: all six
    VMResult fields equal the CPU run's."""
    from killerbeez_tpu_torch.models.vm import run_batch

    for name in ("tlvstack_vm", "fixedform_vm"):
        L = 128 if name == "fixedform_vm" else 64
        prog, _, _, seed, _, _, _ = _setup(name, cuda, B=512, L=L)
        g = torch.Generator().manual_seed(5)
        bufs = seed.cpu()[None, :].repeat(512, 1)
        flip = torch.rand((512, L), generator=g) < 0.1
        bufs = torch.where(flip, torch.randint(0, 256, (512, L),
                                               generator=g,
                                               dtype=torch.uint8), bufs)
        lens = torch.randint(1, L + 1, (512,), generator=g,
                             dtype=torch.int32)
        ref = run_batch(prog, bufs, lens, record_stream=True)
        got = run_batch(prog, bufs.to(cuda), lens.to(cuda),
                        record_stream=True)
        _equal(got, ref)


def test_ipt_step_on_the_card_equals_the_cpu(cuda):
    """ipt's unfiltered step (kbz_vm_kernel over every lane) and its
    filtered step (the stream engine, murmur3) on the card: the same
    verdicts, hash sets and state as on the CPU."""
    import json

    from killerbeez_tpu_torch.instrumentation.ipt import IptInstrumentation

    prog, _, _, seed, _, _, _ = _setup("tlvstack_vm", cuda, B=1024)
    g = torch.Generator().manual_seed(9)
    bufs = seed.cpu()[None, :].repeat(1024, 1)
    flip = torch.rand((1024, 64), generator=g) < 0.1
    bufs = torch.where(flip, torch.randint(0, 256, (1024, 64), generator=g,
                                           dtype=torch.uint8), bufs)
    lens = torch.randint(1, 65, (1024,), generator=g, dtype=torch.int32)
    for opts in ({"target": "tlvstack_vm"},
                 {"target": "tlvstack_vm", "filters": [[0, 30000]]}):
        before = vk.LAUNCHES["kbz_vm_kernel_all"]
        card = IptInstrumentation(json.dumps(opts))
        host = IptInstrumentation(json.dumps(opts), device="cpu")
        a = card.run_batch(bufs.to(cuda), lens.to(cuda))
        b = host.run_batch(bufs, lens)
        _equal(a, b)
        assert card.get_state() == host.get_state()
        assert vk.LAUNCHES["kbz_vm_kernel_all"] - before == \
            (0 if "filters" in opts else 1)


# -- the mesh (parallel/): dp = 4, mp = 2 shards on one card ---------------

def _mesh_run(devices, engine):
    """Two mesh steps, a K = 2 superbatch and two -G 4 dispatches on
    cgc_like (dp = 4, mp = 2, 32 lanes per shard); returns every
    output as CPU tensors."""
    from killerbeez_tpu_torch.parallel import (
        make_mesh, make_sharded_fuzz_step, make_sharded_generations,
        sharded_gen_ring_init, sharded_state_init,
    )
    prog = get_target("cgc_like")
    mesh = make_mesh(4, 2, devices)
    dev = mesh.devices[0][0]
    seed = torch.zeros(16, dtype=torch.uint8, device=dev)
    seed[:8] = torch.tensor(list(b"CG\x02\x04\x05\x41xx"),
                            dtype=torch.uint8)
    step = make_sharded_fuzz_step(prog, mesh, 32, 16, engine=engine,
                                  seed=11)
    st = sharded_state_init(mesh, prog.map_size)
    out = []
    for base in (0, 128):
        st, *r = step(st, seed, 8, base)
        out += r[:7] + list(r[7])
    st, *r = step.multi(st, seed, 8, 256, 2)
    out += r[:3] + list(r[3])
    dispatch = make_sharded_generations(prog, mesh, 32, 16, engine=engine,
                                        seed=11, salt=11, adm_cap=4,
                                        findings_cap=64)
    ring = sharded_gen_ring_init(mesh, seed, 8, 8, 16)
    for gen0, reseed in ((0, True), (4, False)):
        st, ring, rep = dispatch(st, ring, 512 + gen0 * 128, gen0, 4,
                                 reseed=reseed, fold_every=2)
        out += list(rep)
    out += [ring.field(f) for f in ("bufs", "lens", "filled", "hits",
                                    "finds", "ptr")]
    out += [st.full_map(m) for m in ("virgin_bits", "virgin_crash",
                                     "virgin_tmout")]
    return [t.cpu() for t in out]


@pytest.mark.parametrize("engine", ["cuda", "cuda_fused"])
def test_mesh_on_one_card_matches_cpu(engine, cuda):
    """A dp = 4, mp = 2 mesh on ["cuda:0"] * 8 (the unfused engine runs
    kbz_vm_kernel over every lane, the fused one kbz_fuzz_kernel) equals
    the plain path on ["cpu"] * 8: steps, superbatch, generation
    reports, rings and maps."""
    before = dict(vk.LAUNCHES)
    got = _mesh_run(["cuda:0"] * 8, engine)
    ref = _mesh_run(["cpu"] * 8, "torch")
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and torch.equal(
            a.to(torch.int64), b.to(torch.int64)), i
    # 4 dp rows x (2 steps + 2 superbatch steps + 8 generations)
    name = "kbz_fuzz_kernel" if engine == "cuda_fused" \
        else "kbz_vm_kernel_all"
    assert vk.LAUNCHES[name] - before[name] == 4 * 12


def test_mesh_never_waits_for_the_card(cuda):
    """A mesh step, a K = 2 superbatch and a -G 4 mesh dispatch with its
    report's host copies only enqueue work on a dp = 4, mp = 2 mesh on
    one card: nothing waits for the card (sync debug mode "error")."""
    from killerbeez_tpu_torch.ops.generations import MeshGenerationOutcome
    from killerbeez_tpu_torch.parallel import (
        make_mesh, make_sharded_fuzz_step, make_sharded_generations,
        sharded_gen_ring_init, sharded_state_init,
    )
    prog = get_target("tlvstack_vm")
    mesh = make_mesh(4, 2, ["cuda:0"] * 8)
    sb = targets_cgc.tlvstack_vm_seed()
    seed = torch.zeros(64, dtype=torch.uint8, device="cuda")
    seed[:len(sb)] = torch.tensor(list(sb), dtype=torch.uint8)
    for engine in ("cuda", "cuda_fused"):
        step = make_sharded_fuzz_step(prog, mesh, 512, 64, engine=engine)
        dispatch = make_sharded_generations(prog, mesh, 512, 64,
                                            engine=engine, findings_cap=64)
        st = sharded_state_init(mesh, prog.map_size)
        ring = sharded_gen_ring_init(mesh, seed, len(sb), 32, 64)
        # first use: the kernel build, allocations, cached tables
        st = step(st, seed, len(sb), 0)[0]
        st, ring, _ = dispatch(st, ring, 2048, 0, 2)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            st, *out = step(st, seed, len(sb), 4096)
            st, *multi = step.multi(st, seed, len(sb), 6144, 2)
            st, ring, rep = dispatch(st, ring, 10240, 2, 4)
            report = MeshGenerationOutcome(
                *rep, ring_filled=ring.filled, gen0=2, g=4, n_real=2048,
                cap=64, n_shards=4).prefetch()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        h = report.materialize()
        assert h.fr_pack.shape[0] == 4 and h.sel.shape == (4, 4)
        assert out[0].shape == (2048,) and multi[0].shape == (2, 2048)


def test_make_mesh_refuses_more_shards_than_cards(cuda, tmp_path, capsys):
    """More shards than cards: make_mesh raises, and the CLI's --mesh
    exits 2 naming the count."""
    from killerbeez_tpu_torch.fuzzer.cli import main
    from killerbeez_tpu_torch.parallel import make_mesh
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"need {n + 1} devices, have {n}"):
        make_mesh(n + 1, 1)
    assert len(make_mesh(n, 1).devices) == n
    assert main(["file", "jit_harness", "havoc", "-ss", "CG\x02\x04",
                 "-i", '{"target": "cgc_like"}', "-o", str(tmp_path),
                 "-b", str(64 * (n + 1)), "-n", str(64 * (n + 1)),
                 "--mesh", f"{n + 1},1"]) == 2
    assert f"need {n + 1} devices, have {n}" in capsys.readouterr().err


MUTATOR_CASES = [
    ("nop", None), ("bit_flip", '{"num_bits": 1}'),
    ("bit_flip", '{"num_bits": 32}'), ("arithmetic", None),
    ("interesting_value", None), ("dictionary", '{"target": "tlvstack_vm"}'),
    ("havoc", '{"seed": 3}'), ("zzuf", '{"seed": 3}'), ("ni", '{"seed": 3}'),
    ("honggfuzz", '{"seed": 3}'), ("splice", None), ("afl", '{"seed": 3}'),
]


@pytest.mark.parametrize("name,opts", MUTATOR_CASES)
def test_mutators_never_wait_for_the_card(name, opts, cuda, tmp_path):
    """Each randomized and deterministic mutator on the card: a seed
    swap and batches (afl's across its last deterministic stage into
    havoc) under sync debug mode "error" — a copy from pageable memory,
    a ``.item()`` or a ``nonzero`` would raise — and the same bytes as
    on the CPU.  manager and radamsa make their candidates on the host
    by design."""
    from killerbeez_tpu_torch.mutators import mutator_factory
    seed = targets_cgc.tlvstack_vm_seed()
    if name == "splice":
        (tmp_path / "a").write_bytes(seed[::-1])
        (tmp_path / "b").write_bytes(seed[:9] + b"\xff" * 30)
        opts = '{"seed": 3, "corpus_dir": "%s"}' % tmp_path
    muts = {dev: mutator_factory(name, opts, seed, device=dev)
            for dev in ("cuda", "cpu")}
    m = muts["cuda"]
    m.mutate_batch(64)        # first use: tables, the base key, the seed
    torch.cuda.synchronize()
    swapped = seed[:20] + seed[:7]
    start = 12000 if name == "afl" else 0        # afl: det_total 12024
    got = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        m.set_input(swapped, keep_length=True)
        m.iteration = start
        for n in (1000, 77):
            if m.remaining():
                got.append(m.mutate_batch(min(n, m.remaining())))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = muts["cpu"]
    ref.set_input(swapped, keep_length=True)
    ref.iteration = start
    for bufs, lens in got:
        rb, rl = ref.mutate_batch(bufs.shape[0])
        assert torch.equal(bufs.cpu(), rb) and torch.equal(lens.cpu(), rl)


@pytest.mark.parametrize("device_triage", [0, 1])
def test_host_batches_wait_only_for_their_copies(device_triage, cuda):
    """The host-execution tier on the card: ``stdin afl havoc`` batches
    of the port's own ``test`` build, each generating the next batch
    while its processes run.  With the numpy triage, the batches after
    the first run under sync debug mode "error": the host waits only
    on the prefetched copies' events (which the mode does not count).
    With ``device_triage`` 1 the triage reads its verdicts back at
    once, so it runs outside the mode.  Both equal the CPU stack's
    results, state and candidates."""
    import json

    import numpy as np

    from killerbeez_tpu_torch.drivers import driver_factory
    from killerbeez_tpu_torch.instrumentation import \
        instrumentation_factory
    from killerbeez_tpu_torch.mutators import mutator_factory
    from killerbeez_tpu_torch.native.build import corpus_path
    dopts = json.dumps({"path": corpus_path("test")})
    iopts = json.dumps({"device_triage": device_triage})
    stacks = {}
    for dev in ("cuda", "cpu"):
        instr = instrumentation_factory("afl", iopts, device=dev)
        mut = mutator_factory("havoc", '{"seed": 3}', b"ABC@zzzz",
                              device=dev)
        stacks[dev] = driver_factory("stdin", dopts, instr, mut,
                                     device=dev)
    outs = {"cuda": [], "cpu": []}
    drv = stacks["cuda"]
    outs["cuda"].append(drv.test_batch(512, prefetch_next=512))
    torch.cuda.synchronize()
    if not device_triage:
        torch.cuda.set_sync_debug_mode("error")
    try:
        for n, nxt in ((512, 300), (300, 0)):
            outs["cuda"].append(drv.test_batch(n, pad_to=512,
                                               prefetch_next=nxt))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for n in (512, 512, 300):
        outs["cpu"].append(stacks["cpu"].test_batch(n, pad_to=512,
                                                    prefetch_next=0))
    for got, ref in zip(outs["cuda"], outs["cpu"]):
        for a, b in zip(list(got.result) + [got.inputs, got.lengths],
                        list(ref.result) + [ref.inputs, ref.lengths]):
            np.testing.assert_array_equal(a, b)
    assert stacks["cuda"].instrumentation.get_state() == \
        stacks["cpu"].instrumentation.get_state()
    for d in stacks.values():
        d.instrumentation.cleanup()


# -- the crack and search tier ----------------------------------------

def test_distances_on_the_card_equal_the_cpu(cuda):
    """``run_batch_distances`` (plain torch ops on the card) == the CPU:
    the five VMResult fields, the float32 distances, the captures."""
    from killerbeez_tpu_torch.models.vm import run_batch_distances
    from killerbeez_tpu_torch.search.objective import edge_objectives
    for name in ("magicsum_vm", "tlvstack_vm"):
        prog = get_target(name)
        specs = tuple(o.spec() for f, t in zip(prog.edge_from,
                                               prog.edge_to)
                      for o in edge_objectives(prog, (int(f), int(t))))[:8]
        gen = torch.Generator().manual_seed(7)
        x = torch.randint(0, 256, (2048, 48), generator=gen,
                          dtype=torch.uint8)
        y = torch.randint(0, 49, (2048,), generator=gen, dtype=torch.int32)
        for capture in (False, True):
            cpu = run_batch_distances(prog, x, y, specs, capture)
            card = run_batch_distances(prog, x.cuda(), y.cuda(), specs,
                                       capture)
            _equal(cpu[0], card[0])
            for a, b in zip(cpu[1:], card[1:]):
                assert torch.equal(a, b.cpu())


def test_focused_mutators_on_the_card_equal_the_cpu(cuda):
    """Focused havoc, zzuf and afl's havoc tail: card == CPU, and no
    wait for the card while the mask is installed."""
    from killerbeez_tpu_torch.mutators import mutator_factory
    seed = targets_cgc.tlvstack_vm_seed()
    for name, opts in (("havoc", '{"seed": 3}'), ("zzuf", '{"seed": 3}'),
                       ("afl", '{"seed": 3, "skip_deterministic": 1}')):
        muts = {dev: mutator_factory(name, opts, seed, device=dev)
                for dev in ("cuda", "cpu")}
        for m in muts.values():
            m.set_focus_mask([0, 3, 9, 17])
        muts["cuda"].mutate_batch(64)
        muts["cpu"].mutate_batch(64)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = muts["cuda"].mutate_batch(4096)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ref = muts["cpu"].mutate_batch(4096)
        assert torch.equal(got[0].cpu(), ref[0])
        assert torch.equal(got[1].cpu(), ref[1])


def test_device_descent_on_the_card_equals_the_cpu(cuda):
    """Stepped and in-scan descent on the card: the same elite front
    and witnesses as each other and as the CPU."""
    import numpy as np
    from killerbeez_tpu_torch.search import DeviceDescent
    prog = get_target("magicsum_vm")
    runs = []
    for dev, si, n in (("cuda", 1, 4), ("cuda", 4, 1), ("cpu", 4, 1)):
        eng = DeviceDescent(prog, (2, 4), [bytes(6)], lanes=256,
                            scan_iters=si, device=dev)
        rows = [r for _ in range(n) for r in eng.dispatch()]
        runs.append((eng.elite_front(), rows, eng.witnesses_total,
                     eng.best_primary))
    for other in runs[1:]:
        for a, b in zip(runs[0][0], other[0]):
            np.testing.assert_array_equal(a, b)
        assert runs[0][1:] == other[1:]


def test_focus_mask_runs_the_unfused_kernel(cuda):
    """With a focus mask installed the ``cuda_fused`` engine runs the
    focused candidates through ``kbz_vm_kernel`` over every lane; once
    it clears, ``kbz_fuzz_kernel`` runs again."""
    import json
    from killerbeez_tpu_torch.drivers.factory import driver_factory
    from killerbeez_tpu_torch.instrumentation.factory import (
        instrumentation_factory,
    )
    from killerbeez_tpu_torch.mutators import mutator_factory
    instr = instrumentation_factory(
        "jit_harness", json.dumps({"target": "test",
                                   "engine": "cuda_fused"}))
    mut = mutator_factory("havoc", '{"seed": 11}', b"ABC@")
    drv = driver_factory("file", None, instr, mut)
    drv.test_batch(1024)
    mut.set_focus_mask([0, 3])
    before = dict(vk.LAUNCHES)
    out = drv.test_batch(1024)
    twin = mutator_factory("havoc", '{"seed": 11}', b"ABC@", device="cpu")
    twin.iteration = 1024
    twin.set_focus_mask([0, 3])
    tb, _ = twin.mutate_batch(1024)
    assert torch.equal(out.inputs.cpu(), tb)
    assert vk.LAUNCHES["kbz_vm_kernel_all"] == \
        before["kbz_vm_kernel_all"] + 1
    assert vk.LAUNCHES["kbz_fuzz_kernel"] == before["kbz_fuzz_kernel"]
    mut.set_focus_mask(None)
    drv.test_batch(1024)
    assert vk.LAUNCHES["kbz_fuzz_kernel"] == before["kbz_fuzz_kernel"] + 1


@pytest.mark.parametrize("name", ["session_auth", "tcp_like"])
def test_session_executor_on_the_card_equals_the_cpu(name, cuda):
    """The session executor (plain torch on the card) and both state
    triages on 4096 havoc mutants of the framed seed: every
    SessionResult field, the rets and virgin_state equal the CPU's, and
    no kernel launches."""
    from killerbeez_tpu_torch.models import targets_stateful as ts
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator
    from killerbeez_tpu_torch.stateful import coverage as sc
    from killerbeez_tpu_torch.stateful.session import run_session_batch
    prog, spec = get_target(name), ts.get_stateful_spec(name)
    mut = HavocMutator('{"seed": 5}', ts.framed_seed(name), device="cpu")
    bufs, lens = mut.mutate_batch(4096)
    before = dict(vk.LAUNCHES)
    got = run_session_batch(prog, bufs.to(cuda), lens.to(cuda), spec)
    ref = run_session_batch(prog, bufs, lens, spec)
    _equal(got, ref)
    v0 = sc.fresh_virgin_state(spec.n_states, prog.n_edges)
    for tri in (sc.state_triage, sc.state_triage_exact):
        _equal(tri(v0.to(cuda), got.se_counts), tri(v0, ref.se_counts))
    assert vk.LAUNCHES == before


def test_stateful_generations_on_the_card_equal_the_cpu(cuda):
    """A stateful -G 4 dispatch on the card: every outcome field and
    virgin_state equal the CPU's, and no VM kernel launches (the session
    executor is plain torch); its classic triage is the triage kernels,
    one launch a generation."""
    import json
    from killerbeez_tpu_torch.instrumentation.jit_harness import (
        JitHarnessInstrumentation,
    )
    from killerbeez_tpu_torch.models import targets_stateful as ts
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator
    instr = JitHarnessInstrumentation(json.dumps(
        {"target": "tcp_like", "stateful": 1, "novelty": "throughput"}))
    twin = JitHarnessInstrumentation(json.dumps(
        {"target": "tcp_like", "stateful": 1, "novelty": "throughput"}),
        device="cpu")
    seed = ts.framed_seed("tcp_like")
    outs = []
    before = dict(vk.LAUNCHES)
    for ins, dev in ((instr, "cuda"), (twin, "cpu")):
        mut = HavocMutator('{"seed": 11}', seed, device=dev)
        outs.append(ins.run_batch_generations(
            mut, mut.peek_iterations(2048), 4).materialize())
    assert vk.LAUNCHES == {**before,
                           "kbz_triage": before["kbz_triage"] + 4}
    for f in outs[0]._fields:
        a, b = getattr(outs[0], f), getattr(outs[1], f)
        if hasattr(a, "shape"):
            assert (a == b).all(), f
    assert torch.equal(instr.virgin_state.cpu(), twin.virgin_state)


GRAMMAR_TARGETS = ["zoo:tlv:depth=2,bug=1", "zoo:chain:width=3,bug=1",
                   "zoo:cksum:style=sum,bug=1"]


@pytest.mark.parametrize("name", GRAMMAR_TARGETS + ["degenerate"])
def test_grammar_havoc_at_on_the_card_equals_the_cpu(name, cuda):
    """grammar_havoc_at on 8192 lanes gives the same bytes and lengths
    on the card as on the CPU; with the degenerate tables it is
    havoc_at on the card."""
    from killerbeez_tpu_torch.grammar import compile_grammar
    from killerbeez_tpu_torch.grammar.device import grammar_havoc_at
    from killerbeez_tpu_torch.grammar.tables import degenerate_tables
    from killerbeez_tpu_torch.models.zoo import build_zoo
    from killerbeez_tpu_torch.ops.mutate_core import havoc_at
    if name == "degenerate":
        tables, sb = degenerate_tables(), targets_cgc.tlvstack_vm_seed()
    else:
        t = build_zoo(name)
        tables, sb = compile_grammar(t.grammar), t.seed
    seed = torch.zeros(64, dtype=torch.uint8)
    seed[:len(sb)] = torch.tensor(list(sb), dtype=torch.uint8)
    its = torch.arange(8192, dtype=torch.int64)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        keys = prng.fold_in(prng.key(7, device=dev), its.to(dev))
        outs.append(grammar_havoc_at(seed.to(dev), len(sb), keys, tables,
                                     tables.device(dev)))
    _equal(outs[0], outs[1])
    if name == "degenerate":
        keys = prng.fold_in(prng.key(7, device=cuda), its.to(cuda))
        _equal(outs[0], havoc_at(seed.to(cuda), len(sb),
                                 vk.havoc_words_for_keys(keys)))


def test_grammar_generations_dispatch_never_waits_for_the_card(cuda):
    """A grammar -G 4 dispatch on the card (engine cuda): each
    generation draws its lanes with grammar_havoc_at from the ring's
    selected slot and runs them through kbz_vm_kernel over every lane,
    enqueueing work only (a host sync raises under sync debug mode
    "error"); the outcome equals the CPU's."""
    import json
    from killerbeez_tpu_torch.drivers.factory import driver_factory
    from killerbeez_tpu_torch.instrumentation.jit_harness import (
        JitHarnessInstrumentation,
    )
    from killerbeez_tpu_torch.models.zoo import build_zoo
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator
    t = build_zoo("zoo:tlv:depth=2,bug=1")
    iopts = json.dumps({"target": t.name, "novelty": "throughput",
                        "grammar": t.grammar.to_json()})
    outs = []
    for dev in ("cuda", "cpu"):
        instr = JitHarnessInstrumentation(iopts, device=dev)
        mut = HavocMutator('{"seed": 7}', t.seed, device=dev)
        drv = driver_factory("file", None, instr, mut, device=dev)
        first = drv.test_batch_generations(2048, 4).materialize()
        if dev == "cuda":
            torch.cuda.synchronize()
            before = dict(vk.LAUNCHES)
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = drv.test_batch_generations(2048, 4).prefetch()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert vk.LAUNCHES["kbz_vm_kernel_all"] == \
                before["kbz_vm_kernel_all"] + 4
            assert vk.LAUNCHES["kbz_fuzz_kernel"] == \
                before["kbz_fuzz_kernel"]
        else:
            out = drv.test_batch_generations(2048, 4)
        outs.append((first, out.materialize(), instr))
    for a, b in zip(outs[0][:2], outs[1][:2]):
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            if hasattr(x, "shape"):
                assert (x == y).all(), f
    assert torch.equal(outs[0][2].virgin_bits.cpu(),
                       outs[1][2].virgin_bits)
    assert int(outs[0][1].fr_ptr) > 0


# -- the learn tier ------------------------------------------------------


def _trained_learn_params(dev):
    """Weights one CPU training round made from seeded synthetic
    admissions (early bytes useful), on ``dev``."""
    import numpy as np
    from killerbeez_tpu_torch.learn import LearnTier, model
    rng = np.random.default_rng(5)
    tier = LearnTier(train_interval_s=0.0, min_labels=8, device="cpu")
    for i in range(16):
        parent = rng.integers(0, 256, 32).astype(np.uint8).tobytes()
        for _ in range(3):
            child = bytearray(parent)
            child[int(rng.integers(0, 6))] ^= 0x5A
            tier.note_admission(f"p{i}", parent, bytes(child), "havoc")
    tier.train_round()
    return model.params_from_numpy([p.numpy() for p in tier.params], dev)


@pytest.mark.parametrize("kind", ["ones", "random", "zeros"])
def test_masked_havoc_on_the_card_equals_the_cpu(kind, cuda):
    from killerbeez_tpu_torch.ops.mutate_core import havoc_at, havoc_mask_at
    L, n = 64, 4096
    gen = torch.Generator().manual_seed(3)
    seed = torch.randint(0, 256, (L,), dtype=torch.uint8, generator=gen)
    mask = {"ones": torch.ones(L, dtype=torch.uint8),
            "zeros": torch.zeros(L, dtype=torch.uint8),
            "random": torch.randint(0, 2, (L,), dtype=torch.uint8,
                                    generator=gen)}[kind]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        words = vk.havoc_words_for_keys(prng.fold_in(
            prng.key(3, device=dev), torch.arange(n, device=dev)))
        outs.append(havoc_mask_at(seed.to(dev), 41, words, mask.to(dev)))
        if kind != "random" and dev == cuda:
            _equal(outs[0], havoc_at(seed.to(dev), 41, words))
    _equal(outs[0], outs[1])


@pytest.mark.parametrize("weights", ["v0", "trained"])
def test_learn_generations_on_the_card_equal_the_cpu(weights, cuda):
    """A learn -G 4 dispatch (per-generation inference through the slot
    cache, masked havoc, then kbz_vm_kernel over every lane) on the card
    against the CPU's plain path: every outcome field and the maps."""
    from killerbeez_tpu_torch.instrumentation.jit_harness import (
        JitHarnessInstrumentation,
    )
    from killerbeez_tpu_torch.learn import model
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator
    got = []
    for dev, engine in ((cuda, "cuda"), (torch.device("cpu"), "torch")):
        instr = JitHarnessInstrumentation(
            '{"target": "tlvstack_vm", "engine": "%s", "learn": 1, '
            '"novelty": "throughput"}' % engine, device=dev)
        instr.learn_params = model.init_params(device=dev) \
            if weights == "v0" else _trained_learn_params(dev)
        mut = HavocMutator('{"seed": 3}', targets_cgc.tlvstack_vm_seed(),
                           device=dev)
        before = vk.LAUNCHES["kbz_vm_kernel_all"]
        out = instr.run_batch_generations(mut, mut.peek_iterations(1000), 4,
                                          pad_to=1024).materialize()
        if dev == cuda:
            assert vk.LAUNCHES["kbz_vm_kernel_all"] == before + 4
        got.append((out, [instr.virgin_bits.cpu(), instr.virgin_crash.cpu()]))
    (a, am), (b, bm) = got
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x == y) if isinstance(x, int) else (x == y).all(), f
    for x, y in zip(am, bm):
        assert torch.equal(x, y)


def test_learn_generations_dispatch_never_waits_for_the_card(cuda):
    """A learn -G 4 dispatch with trained weights only enqueues work:
    inference, the slot cache, masked havoc, kbz_vm_kernel, triage and
    the ring (a host sync raises under sync debug mode "error")."""
    from killerbeez_tpu_torch.drivers.factory import driver_factory
    from killerbeez_tpu_torch.instrumentation.jit_harness import (
        JitHarnessInstrumentation,
    )
    from killerbeez_tpu_torch.mutators.randomized import HavocMutator
    instr = JitHarnessInstrumentation(
        '{"target": "tlvstack_vm", "engine": "cuda_fused", "learn": 1, '
        '"novelty": "throughput"}')
    assert instr.engine == "cuda"          # the fused engine stood down
    instr.learn_params = _trained_learn_params(cuda)
    mut = HavocMutator('{"seed": 3}', targets_cgc.tlvstack_vm_seed())
    drv = driver_factory("file", None, instr, mut)
    drv.test_batch_generations(2048, 4, pad_to=2048).materialize()
    torch.cuda.synchronize()
    before = dict(vk.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = drv.test_batch_generations(2000, 4, pad_to=2048).prefetch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    h = out.materialize()
    assert h.g == 4 and int(h.fr_ptr) > 0
    assert vk.LAUNCHES["kbz_vm_kernel_all"] == \
        before["kbz_vm_kernel_all"] + 4
    assert vk.LAUNCHES["kbz_fuzz_kernel"] == before["kbz_fuzz_kernel"]
