"""The port's grammar tier against the JAX package's, on the CPU.  Each
case mirrors one of ``tests/test_grammar.py``:

  * the parity anchor: ``grammar_havoc_at`` over the degenerate tables
    equals ``havoc_at`` (both packages') for every ``stack_pow2``;
  * non-degenerate ``grammar_havoc_at`` against JAX's
    ``jax.vmap(grammar_havoc_at)`` on seeded numpy inputs, and
    ``parse_fields`` against JAX's, over the zoo's grammars, derived
    grammars and the compiler's edge cases;
  * the mask branch of ``_havoc_one`` (``havoc_mask_at``) against
    JAX's, all-zero, all-ones and random masks;
  * the structure compiler's edge cases (tables equal to JAX's);
  * derivation over every built-in target (grammar and tables equal).

The campaigns (``-G``, ``--mesh``, the ``grammar`` mutator's CLI and
the fusion rule) are in ``test_torch_grammar_campaigns.py``.

Tolerance: none (bytes and integer counters)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from killerbeez_tpu.grammar import device as jax_gd
from killerbeez_tpu.grammar.derive import derive_grammar as jax_derive
from killerbeez_tpu.grammar.spec import load_grammar as jax_load
from killerbeez_tpu.grammar.tables import compile_grammar as jax_compile
from killerbeez_tpu.models.targets import get_target as jax_target
from killerbeez_tpu.ops.mutate_core import havoc_at as jax_havoc
from killerbeez_tpu.ops.mutate_core import havoc_mask_at as jax_mask_at
from killerbeez_tpu_torch.grammar.derive import derive_grammar
from killerbeez_tpu_torch.grammar.device import (
    grammar_havoc_at, parse_fields,
)
from killerbeez_tpu_torch.grammar.spec import (
    Grammar, Rule, blob, length, lit, load_grammar, ref, token,
)
from killerbeez_tpu_torch.grammar.tables import (
    DEPTH_CAP, KIND_BLOB, MAX_ENTRIES, compile_grammar, degenerate_tables,
)
from killerbeez_tpu_torch.models.targets import get_target, target_names
from killerbeez_tpu_torch.models.zoo import GATED_NAMES, build_zoo
from killerbeez_tpu_torch.ops import prng
from killerbeez_tpu_torch.ops.mutate_core import havoc_at, havoc_mask_at
from killerbeez_tpu_torch.ops.vm_kernel import havoc_words_for_keys

torch.set_num_threads(1)

SEED = b"ABCD1234"
L = 64
LANES = 48


def _buf(data: bytes, n: int = L) -> np.ndarray:
    out = np.zeros(n, np.uint8)
    out[:len(data)] = np.frombuffer(data, np.uint8)
    return out


def _keys(seed: int, n: int = LANES):
    """The same n lane keys in both packages: fold_in(key(seed), i)."""
    mine = prng.fold_in(prng.key(seed), torch.arange(n))
    ref = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
        jnp.arange(n, dtype=jnp.uint32))
    return mine, ref


def _equal(a, b, what=""):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                  err_msg=what)


def _both_tables(spec_json: str, stage_p: int = 128):
    """(port tables, their CPU tensors, JAX tables' device pytree) of
    one spec, the compiled tables held equal."""
    mine = compile_grammar(load_grammar(spec_json), stage_p=stage_p)
    ref = jax_compile(jax_load(spec_json), stage_p=stage_p)
    for a, b in zip(mine, ref):
        _equal(a, b, "compiled tables")
    return mine, mine.device("cpu"), ref.device()


def _jax_lanes(fn):
    """``fn(buf, length, key)`` vmapped over keys and jitted once."""
    return jax.jit(jax.vmap(fn, in_axes=(None, None, 0)))


def _kernel_pairs(spec_json, buf, lengths, seed, stage_p=256, sp=4):
    """Both packages' grammar_havoc_at over LANES keys of one seed, at
    each length."""
    tables, gt, jgt = _both_tables(spec_json, stage_p)
    keys, jkeys = _keys(seed)
    ref_fn = _jax_lanes(lambda b, ln, k: jax_gd.grammar_havoc_at(
        b, ln, k, jgt, stack_pow2=sp))
    for ln in lengths:
        got = grammar_havoc_at(torch.as_tensor(buf), ln, keys, tables, gt,
                               sp)
        yield ln, got, ref_fn(jnp.asarray(buf), jnp.int32(ln), jkeys)


MAGI = Grammar(rules={"m": Rule("m", (
    lit(b"MAGI"), token([b"\x01", b"\x02"], 1),
    length(of="tail"), blob(0, name="tail")))}, start="m")
PINNED = Grammar(rules={"m": Rule("m", (
    lit(b"AB"), length(of="tail"),
    token([b"\x10\x20"], 2), blob(0, name="tail")))}, start="m")
GARBAGE = Grammar(rules={"m": Rule("m", (
    lit(b"AB"), length(of="t"), blob(0, name="t")))}, start="m")
EMPTY_ALPHA = Grammar(rules={"m": Rule("m", (token([], 1), blob(0)))},
                      start="m")
DEEP = Grammar(rules={"m": Rule("m", (lit(b"X"), ref("m")))}, start="m")

#: (name, spec JSON, seed bytes or None for random, lengths)
CASES = [
    ("magi", MAGI.to_json(), b"MAGI\x01\x03abc", (9,)),
    ("pinned", PINNED.to_json(), b"AB\x04\x10\x20wxyz", (9,)),
    ("garbage", GARBAGE.to_json(), b"\xff" * 32, (0, 1, 31)),
    ("empty_alphabet", EMPTY_ALPHA.to_json(), bytes(16), (8,)),
    ("depth_cap", DEEP.to_json(), None, (40,)),
] + [(name, build_zoo(name).grammar.to_json(), build_zoo(name).seed,
      (len(build_zoo(name).seed),)) for name in GATED_NAMES]


# ---------------------------------------------------------------------------
# the parity anchor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stack_pow2", [1, 2, 3, 4, 5, 6, 7])
def test_degenerate_kernel_bit_identical_to_havoc(stack_pow2):
    """grammar_havoc_at over the degenerate tables == the port's
    havoc_at == JAX's havoc_at, across lanes and lengths."""
    tables = degenerate_tables()
    gt = tables.device("cpu")
    buf = np.random.default_rng(3).integers(0, 256, L).astype(np.uint8)
    ref_fn = _jax_lanes(lambda b, ln, k: jax_havoc(
        b, ln, k, stack_pow2=stack_pow2))
    for i in range(4):
        ln = 4 + 17 * i
        keys, jkeys = _keys(i, 16)
        got, got_len = grammar_havoc_at(torch.as_tensor(buf), ln, keys,
                                        tables, gt, stack_pow2)
        words = havoc_words_for_keys(keys, stack_pow2)
        hv, hv_len = havoc_at(torch.as_tensor(buf), ln, words, stack_pow2)
        _equal(got, hv, "degenerate vs havoc_at")
        _equal(got_len, hv_len, "degenerate vs havoc_at lengths")
        ref, ref_len = ref_fn(jnp.asarray(buf), jnp.int32(ln), jkeys)
        _equal(got, ref, "degenerate vs JAX havoc_at")
        _equal(got_len, ref_len, "degenerate vs JAX havoc_at lengths")


# ---------------------------------------------------------------------------
# the structured kernel and the parse, against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,spec,seed,lengths", CASES,
                         ids=[c[0] for c in CASES])
def test_nondegenerate_kernel_matches_jax(name, spec, seed, lengths):
    raw = np.random.default_rng(11).integers(0, 256, L).astype(np.uint8)
    buf = raw if seed is None else _buf(seed)
    for ln, (got, got_len), (ref, ref_len) in _kernel_pairs(
            spec, buf, lengths, 5):
        _equal(got, ref, f"{name} bytes at length {ln}")
        _equal(got_len, ref_len, f"{name} lengths at length {ln}")
        assert got.shape == (LANES, L)


def test_nondegenerate_kernel_diverges_from_havoc():
    buf = _buf(b"MAGI\x01\x03abc")
    tables = compile_grammar(MAGI, stage_p=256)
    keys, _ = _keys(0)
    got, _ = grammar_havoc_at(torch.as_tensor(buf), 9, keys, tables,
                              tables.device("cpu"))
    hv, _ = havoc_at(torch.as_tensor(buf), 9, havoc_words_for_keys(keys))
    assert not torch.equal(got, hv), "structured stages never engaged"


@pytest.mark.parametrize("name,spec,seed,lengths", CASES,
                         ids=[c[0] for c in CASES])
def test_parse_fields_matches_jax(name, spec, seed, lengths):
    tables, gt, jgt = _both_tables(spec)
    ref_fn = jax.jit(lambda b, ln: jax_gd.parse_fields(b, ln, jgt))
    rng = np.random.default_rng(2)
    bufs = [rng.integers(0, 256, L).astype(np.uint8)]
    if seed is not None:
        bufs.append(_buf(seed))
    for buf in bufs:
        for ln in set(lengths) | {0, 1, L}:
            got = parse_fields(torch.as_tensor(buf), ln, tables, gt)
            ref = ref_fn(jnp.asarray(buf), jnp.int32(ln))
            for f, a, b in zip(got._fields, got, ref):
                _equal(a, b, f"{name} {f} at length {ln}")


def test_parse_fields_protects_lits_and_lens():
    tables = compile_grammar(PINNED)
    raw = b"AB\x04\x10\x20wxyz"
    pf = parse_fields(torch.as_tensor(_buf(raw)), len(raw), tables,
                      tables.device("cpu"))
    mask = pf.mut_mask.numpy()
    assert mask[0] == 0 and mask[1] == 0      # lit pinned
    assert mask[2] == 0                       # length field pinned
    assert mask[3] == 1 and mask[4] == 1      # token mutable
    assert mask[5:9].all()                    # blob mutable
    assert mask[len(raw):].all()              # past structure: anything


# ---------------------------------------------------------------------------
# the mask branch of _havoc_one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stack_pow2", [2, 4])
def test_mask_branch_matches_jax(stack_pow2):
    """havoc_mask_at per lane (all-zero, all-ones and random masks, any
    live length) equals JAX's; the all-ones mask equals havoc_at."""
    rng = np.random.default_rng(stack_pow2)
    n = 24
    buf = rng.integers(0, 256, L).astype(np.uint8)
    masks = (rng.random((n, L)) < 0.3).astype(np.uint8)
    masks[0] = 0
    masks[1] = 1
    lens = rng.integers(1, L + 1, n)
    keys, jkeys = _keys(9, n)
    words = havoc_words_for_keys(keys, stack_pow2)
    got, got_len = havoc_mask_at(torch.as_tensor(buf).expand(n, L),
                                 torch.as_tensor(lens), words,
                                 torch.as_tensor(masks), stack_pow2)
    for i in range(n):
        ref, ref_len = jax_mask_at(jnp.asarray(buf), jnp.int32(lens[i]),
                                   jkeys[i], jnp.asarray(masks[i]),
                                   stack_pow2=stack_pow2)
        _equal(got[i], ref, f"lane {i}")
        assert int(got_len[i]) == int(ref_len)
    ones, ones_len = havoc_mask_at(torch.as_tensor(buf), int(lens[1]),
                                   words, torch.ones(L, dtype=torch.uint8),
                                   stack_pow2)
    hv, hv_len = havoc_at(torch.as_tensor(buf), int(lens[1]), words,
                          stack_pow2)
    _equal(ones, hv, "all-ones mask vs havoc_at")
    _equal(ones_len, hv_len)


# ---------------------------------------------------------------------------
# the structure compiler: edge cases (tables held to JAX's)
# ---------------------------------------------------------------------------


def test_compile_empty_alphabet_guarded():
    tables, gt, _ = _both_tables(EMPTY_ALPHA.to_json(), 256)
    assert int(tables.alpha_n[0]) == 0
    keys, _ = _keys(1, 4)
    out, _ = grammar_havoc_at(torch.zeros(16, dtype=torch.uint8), 8, keys,
                              tables, gt)
    assert out.shape == (4, 16)


def test_compile_empty_rule_is_degenerate():
    g = Grammar(rules={"m": Rule("m", ())}, start="m")
    assert not compile_grammar(g).nondegen


def test_compile_depth_cap_clips_with_one_warning(capsys):
    t = compile_grammar(DEEP)
    err = capsys.readouterr().err
    assert err.count("grammar: clipped") == 1   # one-shot warning
    assert int(t.meta[3]) > 0
    assert KIND_BLOB in t.fp_kind.tolist()
    assert t.fp_kind.tolist().count(0) == DEPTH_CAP
    for a, b in zip(t, jax_compile(jax_load(DEEP.to_json()))):
        _equal(a, b)


def test_compile_entry_cap_clips_with_warning(capsys):
    fields = tuple(lit(bytes([65 + (i % 26)]))
                   for i in range(MAX_ENTRIES + 8))
    g = Grammar(rules={"m": Rule("m", fields)}, start="m")
    t = compile_grammar(g)
    assert int(t.meta[2]) == MAX_ENTRIES
    assert int(t.meta[3]) > 0
    assert capsys.readouterr().err.count("grammar: clipped") == 1
    for a, b in zip(t, jax_compile(jax_load(g.to_json()))):
        _equal(a, b)


def test_compile_deterministic():
    g = derive_grammar(get_target("tlvstack_vm"))
    for x, y in zip(compile_grammar(g), compile_grammar(g)):
        assert np.array_equal(x, y)


def test_load_grammar_roundtrip_and_degenerate():
    g = Grammar(rules={"m": Rule("m", (
        lit(b"\x00\xFF"), token([b"ab"], 2), blob(0)))}, start="m")
    assert load_grammar(g.to_json()).to_json() == g.to_json()
    assert jax_load(g.to_json()).to_json() == g.to_json()
    assert not compile_grammar(load_grammar("degenerate")).nondegen


# ---------------------------------------------------------------------------
# auto-derivation over every built-in target family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(target_names()))
def test_derive_compile_run_every_builtin_target(name):
    """The derived grammar and its tables equal JAX's, and the
    structured mutation runs on every built-in target."""
    g = derive_grammar(get_target(name))
    assert g.to_json() == jax_derive(jax_target(name)).to_json()
    tables, gt, _ = _both_tables(g.to_json(), 256)
    keys, _ = _keys(0, 8)
    out, ln = grammar_havoc_at(torch.zeros(L, dtype=torch.uint8), 16, keys,
                               tables, gt)
    assert out.shape == (8, L) and bool(((ln >= 0) & (ln <= L)).all())


def test_derived_tlvstack_kernel_matches_jax():
    spec = derive_grammar(get_target("tlvstack_vm")).to_json()
    from killerbeez_tpu_torch.models.targets_cgc import tlvstack_vm_seed
    seed = tlvstack_vm_seed()
    [(_, (got, got_len), (ref, ref_len))] = _kernel_pairs(
        spec, _buf(seed), [len(seed)], 3)
    _equal(got, ref)
    _equal(got_len, ref_len)


def test_derive_vsa_only_facts_nondegenerate():
    from killerbeez_tpu_torch.analysis.vsa import analyze_vsa
    from killerbeez_tpu_torch.models.compiler import Assembler
    a = Assembler("affine_only", mem_size=16, max_steps=64)
    a.block()
    a.ldi(1, 0)
    a.ldb(0, 1)
    a.addi(0, 0, 200)                   # only fact: b0+200 == 300
    a.ldi(2, 300)
    a.br("eq", 0, 2, "win")
    a.block()
    a.halt()
    a.label("win")
    a.block()
    a.crash()
    prog = a.build()
    assert not compile_grammar(derive_grammar(prog)).nondegen
    g1 = derive_grammar(prog, vsa=analyze_vsa(prog))
    fields = g1.rules["msg"].fields
    assert fields[0].kind == "lit" and fields[0].value == bytes([100])
    assert compile_grammar(g1).nondegen


def test_derive_degenerate_parity_survives_vsa_source():
    from killerbeez_tpu_torch.analysis.vsa import analyze_vsa
    from killerbeez_tpu_torch.models.compiler import Assembler
    a = Assembler("no_facts", mem_size=16, max_steps=64)
    a.block()
    a.ldi(1, 0)
    a.ldb(0, 1)
    a.halt()
    prog = a.build()
    g0 = derive_grammar(prog)
    assert g0 == derive_grammar(prog, vsa=analyze_vsa(prog))
    assert not compile_grammar(g0).nondegen
    real = get_target("tlvstack_vm")
    assert derive_grammar(real) == derive_grammar(real, vsa=None)
