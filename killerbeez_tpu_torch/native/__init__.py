"""Native (C/C++) host components: the exec backend, the target
runtime, the preload forkserver and the kb-cc wrapper, built from the
repository's ``native/`` sources into ``build/torch_native/`` at first
use (``build.py``); ``exec_backend`` holds the ctypes bindings."""

from .build import (  # noqa: F401
    build_corpus, build_error, build_native, corpus_path, kb_cc_path,
    native_available, preload_path, rt_obj_path,
)
from .exec_backend import ExecTarget, KB_MAP_SIZE  # noqa: F401
