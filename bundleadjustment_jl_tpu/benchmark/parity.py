"""Stage and whole-solve parity against a plain float64 reference.

The reference here is independent of the code under test: numpy float64
throughout, Jacobians by complex-step differentiation of its own
projection, segment sums by ``np.bincount`` and dense 3x3 / 9x9 algebra
per block. :func:`stage_errors` compares every XLA stage of one LM
iteration with it at a fixed linearization point:

- ``assembly.{g_c,g_p,Hcc,Hpp,W}`` — `ops.normal.assemble_blocks`;
- ``rhs`` — the reduced right-hand side of `ops.schur.reduce_system`;
- ``diag`` — `ops.schur.schur_diag_blocks`;
- ``matvec`` — `ops.schur.schur_matvec`;
- ``backsub`` — `ops.schur.back_substitute`;
- ``quad`` — `ops.schur.quad_form`;
- ``objective`` — the trial objective at a moved point.

Each error is the relative 2-norm error ``|x - ref| / |ref|``. The CPU
tests call this at small sizes and ``chip_smoke.py`` at Dubrovnik-356 on
the GPU; :func:`solve_summary` and :func:`cpu_f64_solve` are the
whole-solve comparison (an f32 solve against an f64 solve on the CPU).

Run as ``python -m bundleadjustment_jl_tpu.benchmark.parity --cpu-f64
'<synthetic_bal kwargs as JSON>'`` to print the f64 CPU solve summary of
a problem as one JSON line (the child process of :func:`cpu_f64_solve`).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

# Relative 2-norm error bounds per stored W precision. Sums run in
# another order on the GPU (atomics) than on the CPU, so equality is
# never expected. Each bound sits between the largest stage reading of
# its precision and the reading of a control (`precision_controls`)
# that it must reject. Readings at Dubrovnik-356 on an H100 (400 W),
# with the largest CPU-test reading in brackets:
# - f32 W: every product runs at Precision.HIGHEST; worst stage 1.5e-6
#   (rhs) [1.3e-5, edge-shape tests]; control, one matvec product at
#   Precision.DEFAULT (TF32 on the card): 2.1e-4.
# - bf16 W (8 significant bits): worst 1.7e-3, the stored W itself
#   [1.7e-3]; control, the same product multiplied and accumulated in
#   bf16 instead of f32: 7.1e-2 [1.3e-2].
# - f16 W (11 significant bits, range-equilibrated): worst 2.1e-4, the
#   stored W [2.1e-4]; control, W stored in bf16: 1.7e-3.
TOLERANCE = {"f32": 1e-4, "bf16": 5e-3, "f16": 6e-4}

STAGES = ("assembly", "rhs", "diag", "matvec", "backsub", "quad",
          "objective")

# Options of the whole-solve comparison: tight stopping tests so that the
# f32 and f64 solves stop at the same optimum (ortol 1e-5 is still far above
# the f32 objective's resolution at BAL sizes).
PARITY_SOLVE = dict(max_iters=100, pcg_max_iters=100, lam0_mode="diag",
                    satol=0.0, srtol=0.0, atol=0.0, rtol=1e-6, oatol=0.0,
                    ortol=1e-5)
# Relative agreement of the final f32 and f64 objectives.
SOLVE_RTOL = 1e-4
SOLVED = ("first_order", "small_residual", "small_step", "small_obj_change")


# ---------------------------------------------------------------------------
# float64 reference
# ---------------------------------------------------------------------------

def _cross(a, b):
    return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                     a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                     a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=1)


def project(c, X):
    """BAL projection of rows ``X`` (n, 3) by cameras ``c`` (n, 9).

    Written for complex input (complex-step derivatives): no abs, no
    branch. Rotations must be away from exactly zero.
    Returns (proj (n, 2), z (n,)) with z the camera-frame depth."""
    r, t = c[:, 0:3], c[:, 3:6]
    k1, k2, f = c[:, 6], c[:, 7], c[:, 8]
    theta = np.sqrt(np.sum(r * r, axis=1))[:, None]
    k = r / theta
    cs, sn = np.cos(theta), np.sin(theta)
    kdX = np.sum(k * X, axis=1)[:, None]
    p1 = cs * X + sn * _cross(k, X) + (1.0 - cs) * kdX * k + t
    p2 = -p1[:, 0:2] / p1[:, 2:3]
    n2 = np.sum(p2 * p2, axis=1)
    rho = 1.0 + k1 * n2 + k2 * n2 * n2
    return (f * rho)[:, None] * p2, p1[:, 2]


def _segsum(vals, idx, m):
    vals = vals.reshape(vals.shape[0], -1)
    return np.stack([np.bincount(idx, weights=vals[:, j], minlength=m)
                     for j in range(vals.shape[1])], axis=1)


class Reference:
    """float64 linearization of a problem at its own state."""

    def __init__(self, problem):
        cams = np.asarray(problem.cams, np.float64)
        pts = np.asarray(problem.points, np.float64)
        self.ci = np.asarray(problem.cam_idx)
        self.pi = np.asarray(problem.pnt_idx)
        self.xy = np.asarray(problem.pt2d, np.float64)
        self.w = np.asarray(problem.w, np.float64)
        self.nc, self.np_ = cams.shape[0], pts.shape[0]
        C, X = cams[self.ci], pts[self.pi]
        proj, z = project(C, X)
        wv = self.w * (z != 0.0)
        self.r = (proj - self.xy) * wv[:, None]
        h = 1e-30
        jac = []
        for M, j in [(0, j) for j in range(9)] + [(1, j) for j in range(3)]:
            Cc, Xc = C.astype(complex), X.astype(complex)
            (Cc if M == 0 else Xc)[:, j] += 1j * h
            jac.append(project(Cc, Xc)[0].imag / h)
        J = np.stack(jac, axis=2) * wv[:, None, None]       # (n, 2, 12)
        self.Jc, self.Jp = J[:, :, :9], J[:, :, 9:]
        nc, np_ = self.nc, self.np_
        self.obj = 0.5 * float(np.sum(self.r * self.r))
        self.g_c = _segsum(np.einsum("kia,ki->ka", self.Jc, self.r),
                           self.ci, nc)
        self.g_p = _segsum(np.einsum("kib,ki->kb", self.Jp, self.r),
                           self.pi, np_)
        self.Hcc = _segsum(np.einsum("kia,kib->kab", self.Jc, self.Jc),
                           self.ci, nc).reshape(nc, 9, 9)
        self.Hpp = _segsum(np.einsum("kia,kib->kab", self.Jp, self.Jp),
                           self.pi, np_).reshape(np_, 3, 3)
        self.W = np.einsum("kia,kib->kab", self.Jc, self.Jp)   # (n, 9, 3)
        self.cams, self.points = cams, pts

    def lam_diag(self) -> float:
        """The solver's ``lam0_mode="diag"`` damping at this point."""
        return 1e-3 * max(np.einsum("caa->ca", self.Hcc).max(),
                          np.einsum("paa->pa", self.Hpp).max())

    def stages(self, lam, v, dc, tc, tp) -> dict:
        """Reference outputs of every stage at damping ``lam``; ``v`` and
        ``dc`` are (ncams, 9) camera vectors, ``(tc, tp)`` the trial
        state for the objective."""
        nc, np_, ci, pi, W = self.nc, self.np_, self.ci, self.pi, self.W
        Hcc_l = self.Hcc + lam * np.eye(9)
        Hinv = np.linalg.inv(self.Hpp + lam * np.eye(3))
        Hinv_o = Hinv[pi]
        b = -self.g_c + _segsum(
            np.einsum("kab,kbc,kc->ka", W, Hinv_o, self.g_p[pi]), ci, nc)
        diag = Hcc_l - _segsum(np.einsum("kab,kbc,kdc->kad", W, Hinv_o, W),
                               ci, nc).reshape(nc, 9, 9)
        t = _segsum(np.einsum("kab,ka->kb", W, v[ci]), pi, np_)
        u = np.einsum("pab,pb->pa", Hinv, t)
        Sv = (np.einsum("cab,cb->ca", Hcc_l, v)
              - _segsum(np.einsum("kab,kb->ka", W, u[pi]), ci, nc))
        t = _segsum(np.einsum("kab,ka->kb", W, dc[ci]), pi, np_)
        dp = -np.einsum("pab,pb->pa", Hinv, self.g_p + t)
        Jd = (np.einsum("kia,ka->ki", self.Jc, dc[ci])
              + np.einsum("kib,kb->ki", self.Jp, dp[pi]))
        proj, z = project(np.asarray(tc, np.float64)[ci],
                          np.asarray(tp, np.float64)[pi])
        rt = (proj - self.xy) * (self.w * (z != 0.0))[:, None]
        return {"assembly.g_c": self.g_c, "assembly.g_p": self.g_p,
                "assembly.Hcc": self.Hcc, "assembly.Hpp": self.Hpp,
                "assembly.W": W, "rhs": b, "diag": diag, "matvec": Sv,
                "backsub": dp, "quad": np.sum(Jd * Jd),
                "objective": 0.5 * np.sum(rt * rt)}


# ---------------------------------------------------------------------------
# code under test
# ---------------------------------------------------------------------------

def xla_stages(problem, lam, v, dc, tc, tp, facto: str = "f32",
               branch: str = "auto") -> dict:
    """The same stage outputs from the package's XLA formulations, run on
    JAX's default device. ``branch``: "auto" = the solver's own choice
    of whole-width or streamed forms at this size; "whole" / "chunked"
    force one side of the assembly, Schur diagonal and objective
    streaming."""
    import jax
    import jax.numpy as jnp

    from bundleadjustment_jl_tpu.ops.normal import assemble_blocks
    from bundleadjustment_jl_tpu.ops.residuals import (
        objective, objective_chunked)
    from bundleadjustment_jl_tpu.ops.schur import (
        back_substitute, quad_form, reduce_system, schur_diag_blocks,
        schur_matvec)
    from bundleadjustment_jl_tpu.solver.lm_jit import (
        _maybe_cast_facto, _objective, _w_assemble_dtype)

    fd = {"f32": None, "bf16": jnp.bfloat16, "f16": jnp.float16}[facto]
    n = problem.nobs_pad
    chunk = {"auto": "auto", "whole": None,
             "chunked": max(n // 3 + 1, 1)}[branch]

    def assemble(problem):
        blocks = assemble_blocks(problem, chunk=chunk, with_jr=False,
                                 w_dtype=_w_assemble_dtype(fd))
        return _maybe_cast_facto(blocks, fd), blocks.obj

    def rest(problem, blocks, lam, v, dc, tc, tp):
        sys = reduce_system(problem, blocks, lam)
        dp = back_substitute(sys, dc)
        if branch == "auto":
            obj_t = _objective(problem, tc, tp)
        elif branch == "whole":
            obj_t = objective(problem, tc, tp)
        else:
            obj_t = objective_chunked(problem, tc, tp, chunk)
        return {"rhs": sys.b, "diag": schur_diag_blocks(sys, chunk=chunk),
                "matvec": schur_matvec(sys, v), "backsub": dp,
                "quad": quad_form(problem, blocks, dc, dp),
                "objective": obj_t}

    # Two programs, as in the solver, where W crosses a program (or loop
    # carry) boundary in its storage dtype: inside one program XLA may
    # drop an f32 -> f16 -> f32 round trip (excess precision), and the
    # comparison would not see the stored precision.
    dt = problem.cams.dtype
    blocks, obj0 = jax.jit(assemble)(problem)
    out = jax.jit(rest)(problem, blocks, jnp.asarray(lam, dt),
                        jnp.asarray(v, dt), jnp.asarray(dc, dt),
                        jnp.asarray(tc, dt), jnp.asarray(tp, dt))
    W = np.asarray(blocks.W_f, np.float64).reshape(-1, 9, 3)
    if blocks.w_scale is not None:
        W = W / float(blocks.w_scale)
    out.update({"assembly.g_c": blocks.g_c, "assembly.g_p": blocks.g_p,
                "assembly.Hcc": blocks.Hcc, "assembly.Hpp": blocks.Hpp,
                "assembly.W": W, "obj0": obj0})
    return {k: np.asarray(x, np.float64) for k, x in out.items()}


def probe_vectors(ref: Reference, seed: int = 0):
    """(lam, v, dc, tc, tp): the damping, two camera-space vectors and a
    trial state near the linearization point, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(ref.nc, 9))
    dc = rng.normal(size=(ref.nc, 9)) * 1e-3 * np.abs(ref.cams).mean(0)
    tc = ref.cams + rng.normal(size=ref.cams.shape) * 1e-4
    tp = ref.points + rng.normal(size=ref.points.shape) * 1e-4
    return ref.lam_diag(), v, dc, tc, tp


def rel_err(x, ref) -> float:
    x = np.asarray(x, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    num = float(np.linalg.norm(x[:ref.size] - ref))
    den = float(np.linalg.norm(ref))
    return num / den if den > 0 else num


def stage_errors(problem, facto: str = "f32", branch: str = "auto",
                 ref: Reference | None = None, seed: int = 0) -> dict:
    """{quantity: relative 2-norm error} of every stage (see module
    docstring); W rows beyond ``nobs`` are padding and are compared as
    well (both are zero there)."""
    ref = Reference(problem) if ref is None else ref
    lam, v, dc, tc, tp = probe_vectors(ref, seed)
    want = ref.stages(lam, v, dc, tc, tp)
    got = xla_stages(problem, lam, v, dc, tc, tp, facto, branch)
    errs = {k: rel_err(got[k], want[k]) for k in want}
    errs["obj0"] = rel_err(got["obj0"], ref.obj)
    return errs


def precision_controls(ref: Reference, seed: int = 0) -> dict:
    """Controls for the f32 and bf16 bounds: a product of the Schur
    matvec computed the wrong way on JAX's default device, as relative
    2-norm errors against float64. A sound bound passes the stage
    readings and rejects its control.

    - ``"tf32"``: ``W' v`` summed per point, in the flat form the solver
      takes above ``ops.blockmul.SMALL_N`` rows (an elementwise product,
      then a matmul against a 0/1 (27, 3) group-sum matrix), in f32 at
      ``Precision.DEFAULT``; on the GPU the matmul may round to TF32.
      Its sound twin is the ``matvec`` stage at f32.
    - ``"bf16_accumulation"``: ``W u`` summed per camera with W stored
      in bf16, as in the solver, but multiplied and summed in bf16
      instead of f32.

    (The f16 bound's control is the bf16 stage reading: W stored with
    fewer mantissa bits.) On the CPU the tf32 control is plain f32."""
    import jax
    import jax.numpy as jnp
    _, v, _, _, _ = probe_vectors(ref, seed)
    u = np.random.default_rng(seed + 1).normal(size=(ref.np_, 3))
    want_p = _segsum(np.einsum("kab,ka->kb", ref.W, v[ref.ci]), ref.pi,
                     ref.np_)
    want_c = _segsum(np.einsum("kab,kb->ka", ref.W, u[ref.pi]), ref.ci,
                     ref.nc)
    by_b = np.tile(np.eye(3, dtype=np.float32), (9, 1))     # j -> j % 3
    by_a = np.repeat(np.eye(9, dtype=np.float32), 3, axis=0)  # j -> j // 3

    @jax.jit
    def tf32(W27, v_obs, pi):
        prod = W27 * jnp.repeat(v_obs, 3, axis=1)
        return jax.ops.segment_sum(
            jnp.dot(prod, by_b, precision=jax.lax.Precision.DEFAULT),
            pi, ref.np_)

    @jax.jit
    def bf16_acc(W27, u_obs, ci):
        bf = jnp.bfloat16
        prod = W27.astype(bf) * jnp.tile(u_obs.astype(bf), (1, 9))
        rows = jnp.dot(prod, by_a.astype(bf), preferred_element_type=bf)
        return jax.ops.segment_sum(rows, ci, ref.nc)

    W27 = jnp.asarray(ref.W.reshape(-1, 27), jnp.float32)
    return {"tf32": rel_err(tf32(W27, jnp.asarray(v[ref.ci], jnp.float32),
                                 jnp.asarray(ref.pi)), want_p),
            "bf16_accumulation": rel_err(
                bf16_acc(W27, jnp.asarray(u[ref.pi], jnp.float32),
                         jnp.asarray(ref.ci)), want_c)}


def worst_by_stage(errs: dict) -> dict:
    """Collapse ``assembly.*`` (and ``obj0`` into assembly) to one number
    per stage of :data:`STAGES`."""
    out = {}
    for k, e in errs.items():
        s = "assembly" if k == "obj0" else k.split(".")[0]
        out[s] = max(out.get(s, 0.0), e)
    return out


# ---------------------------------------------------------------------------
# whole-solve comparison
# ---------------------------------------------------------------------------

LADYBUG49 = dict(ncams=49, npnts=7776, obs_per_pnt=4, noise_px=1.0,
                 perturb=2e-2, seed=0, pad_obs_to=512)


def solve_summary(gen: dict, dtype) -> dict:
    """Solve ``synthetic_bal(**gen)`` in ``dtype`` with
    :data:`PARITY_SOLVE` on JAX's default device."""
    from bundleadjustment_jl_tpu.io.synthetic import synthetic_bal
    from bundleadjustment_jl_tpu.solver.lm_jit import (
        STATUS_NAMES, levenberg_marquardt_jit)
    problem, _ = synthetic_bal(dtype=dtype, **gen)
    res = levenberg_marquardt_jit(problem, **PARITY_SOLVE)
    return {"status": STATUS_NAMES[int(res.status)],
            "objective": float(res.objective),
            "iterations": int(res.iterations),
            "platform": problem.cams.devices().pop().platform}


def cpu_f64_solve(gen: dict, timeout: float = 900.0) -> dict:
    """:func:`solve_summary` in float64, in a child process pinned to the
    CPU platform, so that it never opens an accelerator."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "bundleadjustment_jl_tpu.benchmark.parity",
         "--cpu-f64", json.dumps(gen)],
        capture_output=True, text=True, env=env, timeout=timeout,
        check=False)
    if out.returncode != 0:
        raise RuntimeError(f"f64 CPU solve failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def solves_agree(a: dict, b: dict, rtol: float = SOLVE_RTOL) -> bool:
    return (a["status"] in SOLVED and b["status"] in SOLVED
            and abs(a["objective"] - b["objective"])
            <= rtol * abs(b["objective"]))


def _main(argv):
    if len(argv) != 2 or argv[0] != "--cpu-f64":
        raise SystemExit(__doc__)
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    print(json.dumps(solve_summary(json.loads(argv[1]), np.float64)))


if __name__ == "__main__":
    _main(sys.argv[1:])
