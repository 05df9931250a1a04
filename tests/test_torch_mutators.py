"""The port's mutator classes against the JAX package's, bit for bit:
every mutator but grammar (``test_torch_grammar.py`` holds its
structured mutation to JAX's) makes the same candidate bytes and lengths
batch by batch over (and past the stage boundaries of) its walk, a
batch equals its candidates made one at a time, the totals, set_input
(with and without keep_length) and the state strings agree, and each
package loads the other's state; manager's parts through
mutate_extended, the radamsa wrapper over a fake binary, focus masks
(``set_focus_mask``), the registry (grammar included), and the
refusals (a card asked for without one)."""

import json
import sys

import numpy as np
import pytest
import torch

from killerbeez_tpu.mutators import MUTATE_MULTIPLE_INPUTS as J_MULTI
from killerbeez_tpu.mutators.factory import mutator_factory as jax_factory
from killerbeez_tpu.mutators.factory import mutator_names as jax_names
from killerbeez_tpu.utils.serialization import encode_mem_array
from killerbeez_tpu_torch.mutators import (
    MUTATE_MULTIPLE_INPUTS, mutator_factory, mutator_help, mutator_names,
)

# batches here are small: torch's intra-op threads cost more than
# they give, and the test workers already share the cores
torch.set_num_threads(1)

SEED = b"STK1\x01\x0542"          # 8 bytes: every afl stage is short
SEED2 = b"\x00\x10\x20\x30\x40\x50\x60\x70\x80\x90\xa0\xb0"

MUTATORS = [
    ("nop", None),
    ("bit_flip", {"num_bits": 1}),
    ("bit_flip", {"num_bits": 4}),
    ("bit_flip", {"num_bits": 32}),
    ("arithmetic", None),
    ("interesting_value", None),
    ("dictionary", {"tokens": ["AB", "\x01\x02\x03", "Z"]}),
    ("dictionary", {"target": "tlvstack_vm"}),
    ("havoc", {"seed": 3}),
    ("zzuf", {"seed": 4, "ratio_bits": 0.05}),
    ("zzuf", {"seed": 4}),
    ("ni", {"seed": 5, "chunk_size": 3}),
    ("honggfuzz", {"seed": 6, "max_ops": 5}),
    ("splice", {"seed": 7, "corpus": ["hello world, hello",
                                      "AAAAAAAAAAAAAAAAAA", "Q"]}),
    ("afl", {"seed": 8}),
    ("afl", {"seed": 8, "skip_deterministic": 1, "stack_pow2": 2}),
]
IDS = [f"{n}-{json.dumps(o, sort_keys=True) if o else ''}"[:40]
       for n, o in MUTATORS]


def _pair(name, opts, seed=SEED):
    o = json.dumps(opts) if opts else None
    return jax_factory(name, o, seed), mutator_factory(name, o, seed,
                                                       device="cpu")


def _batch(m, n, port):
    b, ln = m.mutate_batch(n)
    if port:
        return b.numpy(), ln.numpy()
    return np.asarray(b), np.asarray(ln)


def _sizes(total):
    """Batch sizes that walk a total (or 2800 iterations of an endless
    mutator: past the start of afl's havoc) in uneven steps."""
    left = 2800 if total < 0 else total
    for n in [1, 7, 64, 5, 300, 129, 2048]:
        if left <= 0:
            return
        yield min(n, left)
        left -= min(n, left)
    while left > 0:
        yield min(500, left)
        left -= min(500, left)


@pytest.mark.parametrize("name,opts", MUTATORS, ids=IDS)
def test_batches_match_jax(name, opts):
    ref, port = _pair(name, opts)
    total = ref.get_total_iteration_count()
    assert port.get_total_iteration_count() == total
    assert port.max_length == ref.max_length
    for n in _sizes(total):
        rb, rl = _batch(ref, n, False)
        pb, pl = _batch(port, n, True)
        np.testing.assert_array_equal(rb, pb)
        np.testing.assert_array_equal(rl, pl)
        assert pb.dtype == np.uint8 and pl.dtype == np.int32
        assert port.get_current_iteration() == ref.get_current_iteration()
    assert port.remaining() == ref.remaining()
    if total >= 0:
        assert port.mutate() is None and ref.mutate() is None
        with pytest.raises(ValueError, match="left"):
            port.mutate_batch(1)
    assert port.get_state() == ref.get_state()


@pytest.mark.parametrize("name,opts", MUTATORS, ids=IDS)
def test_batch_equals_one_at_a_time(name, opts):
    o = json.dumps(opts) if opts else None
    a = mutator_factory(name, o, SEED, device="cpu")
    b = mutator_factory(name, o, SEED, device="cpu")
    total = a.get_total_iteration_count()
    # 90: inside afl's bit-flip stages; a short walk starts a third in
    a.iteration = b.iteration = 90 if total < 0 else total // 3
    n = min(40, a.remaining())
    bufs, lens = a.mutate_batch(n)
    singles = [b.mutate() for _ in range(n)]
    assert [bufs[i, :int(lens[i])].numpy().tobytes()
            for i in range(n)] == singles


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("name,opts", MUTATORS, ids=IDS)
def test_set_input_matches_jax(name, opts, keep):
    """A seed swap resets the walk; with keep_length the buffer width
    stays (afl's stage totals follow the new seed length)."""
    ref, port = _pair(name, opts, seed=SEED2)
    for m, p in ((ref, False), (port, True)):
        _batch(m, 3, p)
        m.set_input(SEED, keep_length=keep)
    assert port.max_length == ref.max_length
    assert port.get_current_iteration() == 0
    assert port.get_total_iteration_count() == ref.get_total_iteration_count()
    if name == "afl":
        assert port.stages == ref.stages
        assert port.det_total == ref.det_total
    n = min(100, port.remaining())
    for x, y in zip(_batch(ref, n, False), _batch(port, n, True)):
        np.testing.assert_array_equal(x, y)
    assert port.get_state() == ref.get_state()


def test_keep_length_rejects_a_wider_seed():
    _, port = _pair("zzuf", {"seed": 1})
    with pytest.raises(ValueError, match="exceeds"):
        port.set_input(b"x" * (port.max_length + 1), keep_length=True)
    assert port.seed_bytes == SEED


@pytest.mark.parametrize("name,opts", MUTATORS, ids=IDS)
def test_state_loads_across_packages(name, opts):
    """Each package loads the other's state string and goes on with the
    same candidates as the package that wrote it would (both made from
    another seed first: set_state swaps the seed as each package does)."""
    ref, port = _pair(name, opts)
    _batch(ref, min(77, ref.remaining()), False)
    _batch(port, min(31, port.remaining()), True)
    for state in (ref.get_state(), port.get_state()):
        ref2, port2 = _pair(name, opts, seed=SEED2)
        ref2.set_state(state)
        port2.set_state(state)
        assert port2.get_state() == ref2.get_state() == state
        n = min(50, ref2.remaining())
        if n:
            for x, y in zip(_batch(ref2, n, False), _batch(port2, n, True)):
                np.testing.assert_array_equal(x, y)


def test_afl_stage_names_and_boundaries():
    """afl's stage walk and names, and batches straddling every stage
    boundary and the start of havoc."""
    ref, port = _pair("afl", {"seed": 2})
    assert port.stages == ref.stages
    edges = np.cumsum([s[2] for s in port.stages])
    for it in [0, *edges - 1, *edges, port.det_total + 5]:
        assert port.stage_name(int(it)) == ref.stage_name(int(it))
    for lo in [int(e) - 3 for e in edges]:
        for m in (ref, port):
            m.iteration = lo
        for x, y in zip(_batch(ref, 6, False), _batch(port, 6, True)):
            np.testing.assert_array_equal(x, y)
    ref.iteration = port.iteration = 0
    for x, y in zip(_batch(ref, port.det_total + 40, False),
                    _batch(port, port.det_total + 40, True)):
        np.testing.assert_array_equal(x, y)


MANAGER_CASES = [
    ({"mutators": ["bit_flip", "havoc"],
      "mutator_options": [None, {"seed": 4}]}, [b"AAAA", b"BBBBBB"]),
    ({"mutators": ["bit_flip", "bit_flip"]}, [b"AB", b"Q"]),
    ({"mutators": ["bit_flip", "zzuf"], "framed": 1, "m_max": 4},
     [b"Lpw", b"Q\x00X"]),
]


@pytest.mark.parametrize("opts,parts", MANAGER_CASES)
def test_manager_matches_jax(opts, parts):
    seed = encode_mem_array(parts).encode()
    ref, port = _pair("manager", opts, seed)
    assert port.get_input_info() == ref.get_input_info()
    assert port.get_total_iteration_count() == \
        ref.get_total_iteration_count()
    assert port.mutate_batch_parts(5) == ref.mutate_batch_parts(5)
    for x, y in zip(_batch(ref, 9, False), _batch(port, 9, True)):
        np.testing.assert_array_equal(x, y)
    # mutate_extended: part 0 advances, the other parts replay
    for _ in range(3):
        for i in range(len(parts)):
            assert port.mutate_extended(MUTATE_MULTIPLE_INPUTS | i) == \
                ref.mutate_extended(J_MULTI | i)
    with pytest.raises(ValueError, match="out of range"):
        port.mutate_extended(MUTATE_MULTIPLE_INPUTS | len(parts))
    assert port.mutate() == ref.mutate()
    assert port.get_input_info() == ref.get_input_info()
    state = ref.get_state()
    assert port.get_state() == state
    port2 = mutator_factory("manager", json.dumps(opts), seed, device="cpu")
    port2.set_state(state)
    assert port2.mutate() == ref.mutate()


def test_manager_framed_seed_and_part_mismatch():
    from killerbeez_tpu.stateful.framing import frame_messages
    from killerbeez_tpu_torch.stateful import framing
    seed = frame_messages([b"Lpw", b"QQ"], 4)
    assert framing.frame_messages([b"Lpw", b"QQ"], 4) == seed
    assert framing.unframe(seed, 4) == [b"Lpw", b"QQ"]
    opts = {"mutators": ["bit_flip", "havoc"], "framed": 1}
    ref, port = _pair("manager", opts, seed)
    assert port.parts == ref.parts
    for x, y in zip(_batch(ref, 40, False), _batch(port, 40, True)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="parts"):
        mutator_factory("manager", '{"mutators": ["bit_flip"]}',
                        encode_mem_array([b"A", b"B"]).encode(),
                        device="cpu")


def test_single_input_mutators_refuse_other_parts():
    port = mutator_factory("bit_flip", None, SEED, device="cpu")
    assert port.mutate_extended(MUTATE_MULTIPLE_INPUTS | 0) is not None
    with pytest.raises(ValueError, match="part 1"):
        port.mutate_extended(MUTATE_MULTIPLE_INPUTS | 1)


FAKE_RADAMSA = """#!{python}
import sys
data = sys.stdin.buffer.read()
s = int(sys.argv[sys.argv.index("-s") + 1])
out = bytes((b + s) & 0xFF for b in data[::-1]) + bytes([s & 0xFF]) * (s % 5)
sys.stdout.buffer.write(out[:s % 7] if s % 11 == 0 else out)
"""


def test_radamsa_over_a_fake_binary_matches_jax(tmp_path):
    fake = tmp_path / "radamsa"
    fake.write_text(FAKE_RADAMSA.format(python=sys.executable))
    fake.chmod(0o755)
    opts = {"path": str(fake), "seed": 40}
    ref, port = _pair("radamsa", opts)
    for n in (1, 13):
        for x, y in zip(_batch(ref, n, False), _batch(port, n, True)):
            np.testing.assert_array_equal(x, y)
    assert port.get_state() == ref.get_state()


def test_radamsa_gate_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    errors = []
    for factory in (jax_factory, lambda *a: mutator_factory(
            *a, device="cpu")):
        with pytest.raises(ValueError) as e:
            factory("radamsa", None, SEED)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "radamsa" in errors[0]


def test_registry_is_the_jax_one_but_grammar():
    """The registry is the JAX package's, grammar now included."""
    assert mutator_names() == sorted(jax_names())
    assert mutator_factory("grammar", None, SEED, device="cpu").name == \
        "grammar"
    with pytest.raises(ValueError, match="unknown mutator"):
        mutator_factory("nosuch", None, SEED, device="cpu")
    text = mutator_help()
    for name in mutator_names():
        assert f"{name} mutator" in text


ALL = MUTATORS + [("manager", {"mutators": ["bit_flip", "havoc"]})]


def _seed_for(name):
    return encode_mem_array([b"AB", b"CD"]).encode() \
        if name == "manager" else SEED


@pytest.mark.parametrize("name,opts", ALL, ids=IDS + ["manager"])
def test_focus_masks_are_refused(name, opts):
    """Focus masks are no longer refused: each mutator's
    ``set_focus_mask`` has the JAX mutator's effect — sorted, deduped,
    positions past the buffer dropped, an empty set clearing the mask,
    ``pad_pow2`` cycling the set — and the next batch (focused for
    havoc, zzuf and afl's havoc tail, unchanged for the walks) equals
    the JAX mutator's."""
    o = json.dumps(opts) if opts else None
    seed = _seed_for(name)
    ref = jax_factory(name, o, seed)
    port = mutator_factory(name, o, seed, device="cpu")
    for positions, pad in (([5, 1, 1, 300, -2, 3], False), ([], False),
                           (None, False), ([0, 2, 4], True),
                           ([7, 6, 0, 1, 99], False)):
        ref.set_focus_mask(positions, pad_pow2=pad)
        port.set_focus_mask(positions, pad_pow2=pad)
        if ref.focus_positions is None:
            assert port.focus_positions is None
        else:
            assert port.focus_positions.dtype == ref.focus_positions.dtype
            np.testing.assert_array_equal(port.focus_positions,
                                          ref.focus_positions)
    n = min(64, ref.remaining())
    rb, rl = _batch(ref, n, False)
    pb, pl = _batch(port, n, True)
    np.testing.assert_array_equal(rb, pb)
    np.testing.assert_array_equal(rl, pl)


@pytest.mark.parametrize("name,opts", ALL, ids=IDS + ["manager"])
def test_every_mutator_asks_for_the_card(name, opts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mutator_factory(name, json.dumps(opts) if opts else None,
                        _seed_for(name))


def test_manager_children_live_on_its_device():
    port = mutator_factory("manager", json.dumps(ALL[-1][1]),
                           _seed_for("manager"), device="cpu")
    assert [c.device.type for c in port.children] == ["cpu", "cpu"]


def test_randomized_mutators_keep_to_their_own_prng():
    """No mutator draws from torch's global generator: its state is the
    same before and after every kind of batch."""
    before = torch.random.get_rng_state()
    for name, opts in MUTATORS:
        _, port = _pair(name, opts)
        _batch(port, min(50, port.remaining()), True)
    assert torch.equal(torch.random.get_rng_state(), before)
