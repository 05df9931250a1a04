"""The port's CLI against the JAX package's: the same campaign on
``tlvstack_vm`` at ``-fb 0`` writes the same md5 sets under
crashes/, hangs/ and new_paths/ and dumps the same instrumentation
state string; each package loads the other's state; unported flags
exit 2 naming the flag."""

import json
import os

import pytest
import torch

from killerbeez_tpu.fuzzer.cli import main as jax_main
from killerbeez_tpu.instrumentation.jit_harness import (
    JitHarnessInstrumentation as JaxJitHarness,
)
from killerbeez_tpu.models.targets_cgc import tlvstack_vm_seed
from killerbeez_tpu_torch.fuzzer.cli import main
from killerbeez_tpu_torch.instrumentation.jit_harness import (
    JitHarnessInstrumentation,
)

# batches here are small: torch's intra-op threads cost more than
# they give, and the test workers already share the cores
torch.set_num_threads(1)

IOPTS = {"target": "tlvstack_vm"}


def _argv(seed, out, *extra):
    return ["file", "jit_harness", "havoc", "-sf", str(seed), "-fb", "0",
            "-m", '{"seed": 3}', "-b", "512", "-o", str(out), *extra]


def _findings(out):
    return {d: sorted(os.listdir(os.path.join(out, d)))
            for d in ("crashes", "hangs", "new_paths")}


@pytest.fixture(scope="module")
def campaigns(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    seed = d / "seed.bin"
    seed.write_bytes(tlvstack_vm_seed())
    jax_rc = jax_main(_argv(seed, d / "jax", "-n", "2048", "--no-stats",
                            "-i", json.dumps({**IOPTS, "engine": "xla"}),
                            "-isd", str(d / "jax.state")))
    rc = main(_argv(seed, d / "torch", "-n", "2048", "--device", "cpu",
                    "-i", json.dumps({**IOPTS, "engine": "torch"}),
                    "-isd", str(d / "torch.state")))
    assert (jax_rc, rc) == (0, 0)
    return d, seed


def test_cli_findings_and_state_match_jax(campaigns):
    d, _ = campaigns
    ref, out = _findings(d / "jax"), _findings(d / "torch")
    assert out == ref
    assert out["new_paths"]
    assert (d / "torch.state").read_text() == (d / "jax.state").read_text()


def test_state_loads_across_packages(campaigns):
    d, seed = campaigns
    jax_state = (d / "jax.state").read_text()
    torch_state = (d / "torch.state").read_text()
    port = JitHarnessInstrumentation(json.dumps(IOPTS), device="cpu")
    port.set_state(jax_state)
    assert port.get_state() == jax_state
    ref = JaxJitHarness(json.dumps(IOPTS))
    ref.set_state(torch_state)
    assert ref.get_state() == torch_state
    port.merge(jax_state)
    ref.merge(torch_state)
    assert port.get_state() == ref.get_state()
    # -isf across packages: each CLI resumes from the other's dump
    assert main(_argv(seed, d / "t2", "-n", "512", "--device", "cpu",
                      "-i", json.dumps(IOPTS), "-isf",
                      str(d / "jax.state"), "-isd",
                      str(d / "t2.state"))) == 0
    assert jax_main(_argv(seed, d / "j2", "-n", "512", "--no-stats",
                          "-i", json.dumps(IOPTS), "-isf",
                          str(d / "torch.state"), "-isd",
                          str(d / "j2.state"))) == 0
    assert (d / "t2.state").read_text() == (d / "j2.state").read_text()
    assert _findings(d / "t2") == _findings(d / "j2")


@pytest.mark.parametrize("extra,flag", [
    (["--auto-repair"], "--auto-repair"),
    (["--sync-manager", "m"], "--sync-manager"),
    (["--learn-interval", "4"], "--learn-interval"),
    (["--hybrid", "test"], "--hybrid"),
    (["--gossip"], "--gossip"), (["--learn"], "--learn"),
])
def test_unported_flag_exits_2(extra, flag, tmp_path, capsys):
    """A flag still unported exits 2 naming it; a flag ported since
    parses, and exits 2 with its own message when misused."""
    misuse = {
        "--sync-manager": (["--sync-manager", "m"],
                           "--sync-manager needs --sync-campaign"),
        "--learn-interval": (["--learn-interval", "4", "--learn",
                              "--crack", "2"],
                             "--learn and --crack are mutually exclusive"),
        "--gossip": (["--gossip"], "--gossip needs --sync-manager"),
        "--learn": (["--learn", "--crack"],
                    "--learn and --crack are mutually exclusive"),
    }
    if flag in misuse:
        (tmp_path / "seed").write_bytes(b"ABCD")
        extra, msg = misuse[flag]
        assert main(_argv(tmp_path / "seed", tmp_path / "o", "--device",
                          "cpu", "-i", json.dumps(IOPTS), *extra)) == 2
        assert msg in capsys.readouterr().err
        return
    argv = _argv(tmp_path / "none", tmp_path / "o", "--device", "cpu",
                 *extra)
    assert main(argv) == 2
    err = capsys.readouterr().err
    assert flag in err and "not ported yet" in err


def test_card_requested_without_one(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["file", "jit_harness", "havoc", "-ss", "AAAA", "-fb", "0",
            "-i", json.dumps(IOPTS), "-o", str(tmp_path)]
    assert main(argv) == 2
    assert "no CUDA card" in capsys.readouterr().err
