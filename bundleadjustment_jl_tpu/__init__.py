"""Bundle-adjustment / SfM engine on JAX/XLA (one GPU or a mesh of them).

A JAX/XLA framework with the capability surface of the reference Julia
package `CelestineAngla/BundleAdjustment.jl` (mounted at /root/reference),
re-architected rather than ported:

- BAL data pipeline (bz2 text reader, synthetic generator, covisibility
  partitioner)                       -> :mod:`bundleadjustment_jl_tpu.io`
- Snavely camera / reprojection model (Rodrigues rotation + radial
  distortion), batched residuals     -> :mod:`bundleadjustment_jl_tpu.models`
- Batched Jacobian blocks, Schur-complement point elimination, block-Jacobi
  PCG                                -> :mod:`bundleadjustment_jl_tpu.ops`
- Levenberg-Marquardt solver (host-stepped and fully-jitted variants)
                                     -> :mod:`bundleadjustment_jl_tpu.solver`
- Mesh sharding of observations with XLA collectives
                                     -> :mod:`bundleadjustment_jl_tpu.parallel`

Reference parity map (file:line cites point into /root/reference):
- `src/ReadFiles.jl:9-53`       -> io/bal.py
- `src/BALNLPModels.jl:11-55`   -> models/camera.py, ops/residuals.py
- `src/JacobianByHand.jl`, `src/AD.jl` -> ops/jacobian.py
- `src/lm.jl`, `src/LevenbergMarquardt.jl`, `src/lm_givens.jl` -> solver/lm.py
- `src/qr_aux.jl`, `src/ldl_aux.jl` (SPQR/LDLT)
      -> ops/schur.py + ops/pcg.py (Schur complement + PCG replace sparse
         factorizations; see SURVEY.md §2.2)
- `src/lma_aux.jl` (equilibration -> block-Jacobi preconditioning in
  ops/pcg.py; COO SpMV -> ops/blockmul.py; mixed precision shims ->
  benchmark/precision.py + solver facto_dtype)
- `src/benchmark.jl`, `src/diffprecsions.jl` -> benchmark/
- `src/SolverScipy.py` -> kept as cross-check in tests/test_scipy_oracle.py
"""

__version__ = "0.1.0"

from bundleadjustment_jl_tpu.models.problem import BAProblem  # noqa: F401
