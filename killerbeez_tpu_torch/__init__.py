"""killerbeez_tpu_torch — the Killerbeez fuzzer on PyTorch and CUDA.

A port of ``killerbeez_tpu`` (the JAX/Pallas package beside it) to
PyTorch, with the VM kernels written by hand in CUDA C++ for Hopper
(``csrc/vm_kernel.cu``).  The module tree mirrors the JAX package so
each counterpart sits at the same relative path; the JAX package is
the reference every module here is held to, bit for bit.

Everything runs on the CUDA card unless the caller asks for the CPU
(``device="cpu"``), where each kernel's plain PyTorch version runs
instead.  Asking for the card without one is an error, never a silent
fall back to the CPU.

Package map (the flagship fuzz loop, the CLI's default campaign, its
device-resident generation loop, the mesh campaign, the trace surface,
every mutator, the host-execution tier, the crack and search tier, the
stateful session tier, the grammar tier and the target zoo, the learn
tier, the fleet, and the hybrid bridge with conformance repair):
  utils/            logging, JSON option parsing, state serialization
  models/           the KBVM bytecode VM (plain torch engines, with the
                    edge stream and the single-lane reference) + targets,
                    and the generated target zoo (``zoo:`` names)
  ops/              PRNG, havoc, hashing, dense and sparse coverage
                    triage, the VM kernels, the device-resident
                    generation loop (-G)
  csrc/             CUDA C++ sources of the kernels
  instrumentation/  jit_harness (with edge reporting), ipt (KBVM and
                    host binaries), and the host backends afl,
                    return_code and debug
  native/           the ctypes exec backend over the repository's
                    native/ sources, built into build/torch_native/
  mutators/         every mutator (havoc fuses into the VM kernel; the
                    rest, grammar included, run unfused)
  grammar/          grammar specs, the structure compiler, structured
                    mutation in torch ops and auto-derivation
  learn/            the provenance dataset, the byte-saliency model
                    (trained on the card) and the learn tier (--learn)
  drivers/          file, stdin, network_server, network_client
  corpus/           the corpus store, the seed schedulers, corpus
                    sync, gossip and quarantine
  manager/          the fleet manager (REST + work queue) and its
                    worker
  hybrid/           the native⇄device bridge: proxy bindings and their
                    certification (proxy verdicts through kbz_vm_kernel),
                    seed translation, cross-tier validation, proxy-gap
                    storage and the per-tier fleet reconciliation
  analysis/         the block CFG, the static edge prior, the dataflow
                    analysis behind the auto-dictionary, the solver,
                    value sets, and conformance and repair over
                    proxy-gap counterexamples
  stateful/         the session tier: sequence framing, the session
                    executor (plain torch on the card), state x edge
                    triage, the protocol analysis and per-message
                    dictionaries
  telemetry/        metrics registry, stats files, event log, span ring
  resilience/       chaos points, checkpoints, the dispatch watchdog,
                    the supervisor (kbz-supervise), fleetsim
  parallel/         the mesh campaign (--mesh dp,mp)
  fuzzer/           the batched main loop (corpus feedback), the crack
                    and repair stages + CLI
  tools/            tracer, showmap, merger, minimize, picker, kb-solve,
                    kb-lint, kb-descend, kb-zoo, kb-corpus, kb-timeline,
                    kb-stats, kb-fleet, kb-repair, and diagnostics run
                    on the card
"""

__version__ = "0.1.0"

MAP_SIZE_POW2 = 16
MAP_SIZE = 1 << MAP_SIZE_POW2  # AFL-compatible edge bitmap size

# the fuzzer CLI's -b/--batch-size default
DEFAULT_BATCH_SIZE = 1024

# Fuzz verdicts (reference killerbeez-utils global_types.h)
FUZZ_NONE = 0
FUZZ_HANG = 1
FUZZ_CRASH = 2
FUZZ_RUNNING = 3
FUZZ_ERROR = 4

FUZZ_RESULT_NAMES = {
    FUZZ_NONE: "none",
    FUZZ_HANG: "hang",
    FUZZ_CRASH: "crash",
    FUZZ_RUNNING: "running",
    FUZZ_ERROR: "error",
}


def resolve_device(device="cuda"):
    """The ``torch.device`` for a constructor's ``device`` argument.
    Asking for CUDA on a machine without a card raises: the port never
    carries on on the CPU unless the caller asked for it."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA card is available "
            "(torch.cuda.is_available() is False); pass device=\"cpu\" "
            "(CLI: --device cpu) to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
