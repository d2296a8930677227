"""Multi-device execution: mesh construction and problem sharding.

The reference's only parallelism is shared-memory threads over observation
blocks (`/root/reference/src/BALNLPModels.jl:40-53`, SURVEY.md §2.3). The
analogue here: the observation axis is sharded over a
`jax.sharding.Mesh`; XLA's SPMD partitioner turns every `segment_sum` into
per-device partial sums + collectives over the interconnect
(psum/reduce-scatter), and the PCG camera vectors stay replicated.
"""

from bundleadjustment_jl_tpu.parallel.mesh import (  # noqa: F401
    make_mesh, shard_problem, OBS_AXIS)
