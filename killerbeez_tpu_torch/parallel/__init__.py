"""Multi-device fuzzing tier.

The reference scales by running independent fuzzer processes and
merging coverage offline (merger AND-fold).  Here one controller
process drives a (dp, mp) mesh of devices: the candidate batch shards
over ``dp``, the coverage maps over ``mp``, and the virgin-map union is
an AND-fold across dp after every step (or every ``gen_fold_every``
generations of the mesh-resident generation scan).
"""

from .campaign import ShardedCampaignDriver, parse_mesh_spec
from .distributed import (
    ShardedFuzzState, ShardedGenRing, make_mesh,
    make_sharded_fuzz_step, make_sharded_generations,
    sharded_gen_ring_init, sharded_state_init,
)

__all__ = ["make_mesh", "make_sharded_fuzz_step", "sharded_state_init",
           "make_sharded_generations", "sharded_gen_ring_init",
           "ShardedGenRing", "ShardedFuzzState",
           "ShardedCampaignDriver", "parse_mesh_spec"]
