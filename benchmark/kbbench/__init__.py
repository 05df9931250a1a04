"""The benchmark of ``killerbeez_tpu_torch``: one cell of
``BENCHMARK.json`` run once through a timed window (``run.py``).

Modules: ``spec`` finds a cell's configuration and traffic files by
name, ``campaign`` builds the campaign as the port's CLI builds it and
times it, ``check`` holds what it produced to ``benchmark/reference``,
``stats``, ``devtrace`` and ``arith`` reduce clocks, the profiler's
trace and the work counts to numbers, and ``readers`` loads each
metric's reader from ``benchmark/metrics/<name>.py``.
"""
