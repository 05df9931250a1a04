"""The benchmark's plain reference: the semantics a Killerbeez
campaign's device step must produce, in plain PyTorch and NumPy.

Frozen copies of the plain versions of the PyTorch port, cut to what
the benchmark's cells run (havoc, the KBVM, throughput triage against
the three AFL virgin maps, the ``-G`` seed-slot ring).  They import
neither ``jax`` nor either fuzzer package, so a later change to the
program cannot change the yardstick it is held to.  Everything runs
on the tensors' device.
"""
