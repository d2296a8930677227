"""Compute ops: residuals, Jacobian blocks, normal-equation assembly,
Schur-complement reduction, PCG — the replacement of the
reference's sparse-matrix layer (`src/qr_aux.jl`, `src/ldl_aux.jl`,
`src/lma_aux.jl`)."""

from bundleadjustment_jl_tpu.ops.residuals import residuals, objective  # noqa: F401
from bundleadjustment_jl_tpu.ops.jacobian import (  # noqa: F401
    residuals_and_jacobian, jacobian_blocks_ad)
from bundleadjustment_jl_tpu.ops.normal import (  # noqa: F401
    GNBlocks, assemble_blocks, gradient_norm, inv3x3, damp)
from bundleadjustment_jl_tpu.ops.schur import (  # noqa: F401
    SchurSystem, reduce_system, schur_matvec, schur_diag_blocks,
    back_substitute, predicted_reduction, assemble_dense_schur, solve_dense)
from bundleadjustment_jl_tpu.ops.pcg import (  # noqa: F401
    pcg, PCGResult, block_cholesky, block_cho_solve, forcing_rtol,
    power_series)
from bundleadjustment_jl_tpu.ops.cgls import (  # noqa: F401
    cgls_solve, CGLSResult, j_matvec, jt_matvec)
