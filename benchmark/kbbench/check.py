"""Hold the checked dispatches to the reference.

The reference (``benchmark/reference``) works each dispatch out again
from the inputs the benchmark handed the campaign (the frozen program,
the seed, ``--seed``, the instrumentation's options) and from the
program's state as the dispatch found it: the virgin maps, the seed the
scheduler chose (itself checked: the base seed, a finding or a splice
of two), under ``-G`` the seed-slot ring, and the iteration numbers
counted by the benchmark.  Every number compared is a count of
disagreements, with the limit 0:

  * ``mutant_mismatch``  lanes whose candidate bytes or length differ;
  * ``vm_mismatch``      lanes whose status, exit code, edge counts,
                         steps or path hash differ;
  * ``verdict_mismatch`` lanes whose verdict byte (status, new path,
                         unique crash, unique hang) differs;
  * ``map_mismatch``     virgin-map bytes that differ after the
                         dispatch;
  * ``ring_mismatch``    (``-G``) entries of the dispatch's report
                         (findings ring, slot picks, admission ledger)
                         and of the seed ring after it that differ;
  * ``finding_missing``  findings the reference expects (a crash, a
                         hang, a new path) with no file of those bytes
                         in the campaign's output;
  * ``seed_unknown``     1 when the dispatch's seed is none of the
                         inputs the campaign could have chosen.

A traffic's ``check`` names its kind, ``benchmark/checks/<kind>.py``:
a module with ``check(ctx, pairs, found)``, which returns (readings,
what was checked) for a list of (dispatch, the state it found), and
``control(ctx, pairs)``, which returns the same pairs with the control
in the program's place (its outputs in the dispatches, its findings as
``found``): the control's readings come out of the same ``check``.
"""

from __future__ import annotations

import copy
import hashlib
import importlib.util
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from reference import havoc, prng, triage, vm

from . import spec

M32 = 0xFFFFFFFF
NAMES = ("mutant_mismatch", "vm_mismatch", "verdict_mismatch",
         "map_mismatch", "ring_mismatch", "finding_missing",
         "seed_unknown")
DIRS = {vm.FUZZ_CRASH: "crashes", vm.FUZZ_HANG: "hangs"}
VM_FIELDS = ("status", "exit_code", "counts", "steps", "path_hash")

#: ``found(kind, bytes)``: whether the campaign wrote that finding
Found = Callable[[str, bytes], bool]


class Context:
    """What the reference is handed: the frozen program, the base
    seed, the mutator's seed and options, the instrumentation's options
    as the campaign got them, the campaign's output."""

    def __init__(self, program_file: str, seed_bytes: bytes,
                 mut_seed: int, stack_pow2: int, device: str,
                 out_dir: Optional[str],
                 options: Optional[Dict[str, Any]] = None):
        self.prog = vm.load_program(program_file)
        self.dev = torch.device(device)
        us, seg = triage.static_maps(self.prog.edge_slot)
        self.u_slots = torch.as_tensor(us, device=self.dev)
        self.seg_id = torch.as_tensor(seg, device=self.dev)
        self.seed_bytes = seed_bytes
        self.key = prng.key(mut_seed, device=self.dev)
        self.salt = int(mut_seed) & M32
        self.stack_pow2 = int(stack_pow2)
        self.out_dir = out_dir
        self.options = dict(options or {})


def lanes_differ(a, b) -> torch.Tensor:
    a = a.to(b.device)
    if a.dim() == 1:
        return a.to(torch.int64) != b.to(torch.int64)
    return (a.reshape(a.shape[0], -1).to(torch.int64)
            != b.reshape(b.shape[0], -1).to(torch.int64)).any(1)


def vm_mismatch(got, ref, fields=VM_FIELDS) -> int:
    """Lanes of ``ref`` whose fields differ in ``got`` (its first rows:
    a padded batch has more); every lane when the VM results were not
    kept (``got`` None: no hook of ``benchmark/hooks`` fired once a
    batch)."""
    n = getattr(ref, fields[0]).shape[0]
    if got is None:
        return n
    bad = None
    for f in fields:
        d = lanes_differ(getattr(got, f)[:n], getattr(ref, f))
        bad = d if bad is None else bad | d
    return int(bad.sum())


def kept(d) -> Optional[List[Any]]:
    """What the hooks kept of dispatch ``d``'s VM calls, one a batch
    (or generation), each ``(VM result, mutant bytes, lengths)``; None
    unless there is one for each."""
    return d.vm if len(d.vm) == d.k else None


def mutants(ctx: Context, seed: bytes, L: int, it0: int, n: int):
    buf = torch.zeros(L, dtype=torch.uint8, device=ctx.dev)
    buf[:len(seed)] = torch.tensor(list(seed), dtype=torch.uint8,
                                   device=ctx.dev)
    its = (it0 + torch.arange(n, dtype=torch.int64, device=ctx.dev)) & M32
    words = prng.havoc_words(ctx.key, its, ctx.stack_pow2)
    return havoc.havoc(buf, len(seed), words, ctx.stack_pow2)


def findings_of(statuses, rets, bufs, lens) -> List[Tuple[str, bytes]]:
    """(directory, bytes) of each finding the campaign has to write for
    these lanes: every crash, every hang, every new path."""
    st = statuses.cpu()
    rt = rets.cpu()
    hit = ((st != vm.FUZZ_NONE) | (rt > 0)).nonzero().flatten().tolist()
    if not hit:
        return []
    rows = bufs[hit].cpu().numpy()
    ls = lens[hit].cpu().tolist()
    out = []
    for r, i in enumerate(hit):
        b = rows[r, :ls[r]].tobytes()
        s = int(st[i])
        if s in DIRS:
            out.append((DIRS[s], b))
        if int(rt[i]) > 0:
            out.append(("new_paths", b))
    return out


def on_disk(out_dir: str) -> Found:
    def has(kind: str, buf: bytes) -> bool:
        path = os.path.join(out_dir, kind, hashlib.md5(buf).hexdigest())
        try:
            with open(path, "rb") as f:
                return f.read() == buf
        except OSError:
            return False
    return has


def seed_known(seed: bytes, base: bytes, out_dir: str) -> bool:
    """The scheduler's pick is the base seed, an edge-novel finding, or
    a splice ``a[:k] + b[k:]`` of two findings."""
    if seed == base:
        return True
    d = os.path.join(out_dir, "new_paths")
    found = []
    for name in os.listdir(d):
        with open(os.path.join(d, name), "rb") as f:
            found.append(f.read())
    if seed in found:
        return True

    def common(a, b):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        return n
    pre = max((common(a, seed) for a in found), default=0)
    suf = max((common(b[::-1], seed[::-1]) for b in found
               if len(b) == len(seed)), default=0)
    return pre + suf >= len(seed)


def triage_batch(ctx: Context, maps, out):
    """(status, rets, unique crash, unique hang, maps after) of one
    batch's VM results against ``maps``."""
    st = torch.where(out.status == vm.FUZZ_RUNNING, vm.FUZZ_HANG,
                     out.status).to(torch.int32)
    rets, uc, uh, vb, vc, vh = triage.triage(
        *maps, out.counts, ctx.u_slots, ctx.seg_id, st == vm.FUZZ_CRASH,
        st == vm.FUZZ_HANG)
    return st, rets, uc, uh, (vb, vc, vh)


def maps_differ(a, b) -> int:
    return sum(int((x.to(y.device) != y).sum()) for x, y in zip(a, b))


def new_readings() -> Dict[str, int]:
    return {k: 0 for k in NAMES}


VM_ROWS = 1 << 21


def vm_rows(ctx: Context, bufs, lens, max_steps: int = 0):
    """The VM over many lanes at once, ``VM_ROWS`` lanes a call: one
    step loop for a superbatch's batches instead of one each."""
    outs = [vm.run(ctx.prog, bufs[i:i + VM_ROWS], lens[i:i + VM_ROWS],
                   max_steps) for i in range(0, bufs.shape[0], VM_ROWS)]
    return vm.VMOut(*(torch.cat(col) for col in zip(*outs)))


def row(out, sl):
    return vm.VMOut(*(t[sl] for t in out))


def control_steps(ctx: Context) -> int:
    """The control's broken guarantee: every lane stopped at the
    phase-1 budget of ``max_steps / 8``, the step a two-phase schedule
    would tempt a change to end at."""
    return ctx.prog.max_steps // 8


def stand_in(d, after: Dict[str, Any], vms: List[Any]):
    """Dispatch ``d`` with the control's outputs in the program's
    place."""
    c = copy.copy(d)
    c.after, c.vm = after, vms
    return c


def fresh(ctx: Context) -> dict:
    """The state the campaign's first dispatch finds, worked out from
    the configuration alone: virgin maps all 0xFF, the base seed in a
    buffer of twice its length rounded up to 8 bytes (at least 8),
    iteration 0."""
    seed = ctx.seed_bytes
    maps = tuple(torch.full((ctx.prog.map_size,), 0xFF, dtype=torch.uint8,
                            device=ctx.dev) for _ in range(3))
    return {"maps": maps, "seed": seed,
            "L": max(-(-len(seed) * 2 // 8) * 8, 8)}


_KINDS: Dict[str, Any] = {}


def kind(name: str):
    """The check kind ``benchmark/checks/<name>.py``."""
    mod = _KINDS.get(name)
    if mod is None:
        s = importlib.util.spec_from_file_location(
            "kbbench_check_" + name, spec.bench_path(f"checks/{name}.py"))
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
        _KINDS[name] = mod
    return mod


def run_checks(ctx: Context, name: str, start, sample,
               control: bool = False):
    """The check of the campaign's first dispatch, from the fresh state
    the reference works out itself, and of the window's sampled
    dispatch, from the program's state as it found it.  Returns the
    readings summed over both and what was checked; with ``control``,
    the readings of the control in the program's place."""
    mod = kind(name)
    pairs = [(start, fresh(ctx)), (sample, sample.before)]
    if control:
        pairs, found = mod.control(ctx, pairs)
    else:
        found = on_disk(ctx.out_dir)
    return mod.check(ctx, pairs, found)
