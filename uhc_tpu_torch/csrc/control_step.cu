// One 30 Hz control step of the humanoid (15 stable-PD substeps at 450 Hz)
// for a batch of envs: one thread block per env. The tree's size is a
// compile-time constant (NB bodies, -DNB=<n>; 24 by default), so one
// source gives a library per tree. Three kernels share one copy of the
// physics (`control_step_env`):
//
//  * K1, `control_step_kernel`, all substeps in one launch. Replaces the
//    TPU kernel uhc_tpu/physics/pallas_lane.py:83
//    make_fused_do_simulation_lane (kernel body :393-1195, with the
//    pallas_substep.py Cholesky / triangular-inverse / PCG helpers).
//  * K2, `control_step_head_kernel` + `control_step_tail_kernel`, the
//    head/tail split of uhc_tpu/physics/pallas_substep.py:284
//    make_fused_do_simulation (split=True, :1020-1058): the head runs
//    substep 0 and writes the state and the exact inverses Xp, Xf of A_pd,
//    A_fd to device memory as (B, 2, 75, 75) float32; the tail reads them
//    and runs substeps 1..14. qpos, qvel, Xp and Xf are all the state one
//    substep hands the next, so head + tail equals K1 bit for bit at the
//    same schedule. The round trip adds 2 * 45 KB per env of device
//    memory traffic, small beside the arithmetic.
//  * K1e, the per-env model library of the same TPU kernel (pallas_lane.py
//    `per_env`, :176-222 and the host gather :1283-1305): every entry point
//    takes the model as an (S, P_TOTAL) float library and an optional
//    (B,) int32 `seq_idx`; block `env` reads its model from
//    P + seq_idx[env] * P_TOTAL (a null seq_idx is stride 0: the shared
//    model is the library of one row). Every model read goes through that
//    one pointer, so body, contact, self-collision and limit tables and
//    the contact scalars (friction, stiffness, damping) are all per env.
//    The library (8 shapes × 10 KB) stays in L2; the arithmetic is K1's.
//  * K1d, the big trees of the same TPU kernel (pallas_lane.py with
//    pcg_vpu_sub=True: 48-body masterfoot, 52-body SMPL-H, PCG (2, 2)):
//    the same kernels built with -DNB=48 or -DNB=52. One env's matrices
//    (0.69 / 0.80 MB) exceed a block's 227 KB of shared memory, so they
//    live in a per-env workspace in device memory (`ws`, W_TOTAL floats
//    per env, allocated by the caller) while the state, the per-body
//    vectors and the PCG vectors stay in shared memory. The head/tail
//    split runs over the big trees the same way.
//  * K1f, explicit residual force control (VFX) and per-joint meta-PD
//    (MPJ) of the same TPU kernel (pallas_lane.py:127-146, :878-908 and
//    the host prep :1217-1246): `control_step_f_kernel`, the same physics
//    with two operands of its own, prepared by the wrapper as the JAX
//    wrapper prepares them: a (B, 9·NB) body-frame [cp|f|τ] wrench per
//    body (hull-projected and scaled) and (B, 2, NV) per-dof kp / kd
//    scales. Each substep rotates a body's wrench by its current
//    orientation, gates f and τ by the body's height or by the contact
//    pass's own hull-point test, and adds f and (xpos + cp - xipos) × f + τ
//    to the body's external wrench, which the J6 projection already
//    carries into the dynamics; per-dof scales replace the per-substep
//    ones in the PD gains. The action row is read for the PD targets (and
//    per-substep meta-PD columns) only, so 285- to 423-column actions fit
//    the 128 columns of shared memory at 24 bodies, and 429- to 621-column
//    ones the 256 of a big build. 24 bodies with a shared model or a
//    library (MPJ; the wrapper refuses VFX over a library, as
//    pallas_lane.py:143 does), and the big trees with a shared model,
//    their matrices in the device workspace as in K1d; the two operand
//    regions sit past every other kernel's shared memory. The flags are
//    template-constant off in K1, K1e, K1d and K2.
//  * K1g, `refresh_at` of the same TPU kernel (pallas_lane.py:104-111,
//    :1151-1181): the int table's I_REFRESH names a substep k at which the
//    exact inverse pair is computed again from that substep's A_pd, A_fd,
//    as at substep 0 (-1: none; K2 always passes -1). Its `cond_inv` is
//    this source's layout anyway (the inverse pair runs under a run-time
//    branch of one rolled substep loop), and its `merge_j6` too (phase G
//    projects the bias and external wrenches of every body in one pass).
//
// The plain PyTorch version is uhc_tpu_torch/physics/solver.py
// do_simulation (K1) and its head/tail pieces `substeps` (K2) with the
// same (pd_iters, fd_iters) schedule.
//
// What bounds it on the H100: float32 arithmetic outside the tensor cores
// (67 TFLOP/s). Per env and substep the dense algorithm assembles
// M = GᵀG and CD = J6ᵀ·W·J6 from (144×75) matrices, about 1.6 MFLOP each,
// and substep 0 adds two 75×75 Cholesky inverses; the state it reads and
// writes is under 2 KB per env, so bytes never bound it.
//
// What the design does about it:
//  * at 24 bodies everything of one env stays in shared memory for all 15
//    substeps: the two preconditioners, A_pd, A_fd and the J6 / G (or K)
//    matrices, about 190 KB, so nothing but the state touches device
//    memory (on a big tree the matrices go through L1/L2 to the
//    workspace);
//  * the Jacobian columns of a dof are zero outside the subtree of the
//    dof's body, and bodies are in depth-first order, so every entry of M,
//    CD and Jᵀ·wrench sums over a contiguous range of bodies only (a few
//    percent of the dense work for a limb), and CD skips bodies without an
//    active ground contact;
//  * threads work in parallel over bodies (FK and velocities one tree
//    level at a time), contact points, pairs and matrix entries; the
//    Cholesky factorization runs both systems in lockstep.
// The substep loop stays rolled so nvcc builds it in seconds.
//
// The same source compiles as host C++ (no __CUDACC__): each env then runs
// on one "thread" with __syncthreads a no-op, which is how the CPU tests
// exercise the kernel's arithmetic.

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
#define SYNC() __syncthreads()
#else
#include <vector>
#define HD static inline
#define SYNC() ((void)0)
#endif

// The tree's size is fixed at compile time: build.py compiles one library
// per body count with -DNB=<bodies> (24 by default). Every body but the
// root carries 3 hinge dofs.
#ifndef NB
#define NB 24
#endif
#define NV (6 + 3 * (NB - 1))
#define NQ (NV + 1)
#define NDOF (NV - 6)
#define KPTS 16
#define SC 3
#define MAXPAIR 64
#define NTHREADS 256
#define NTRI (NV * (NV + 1) / 2)
// K1d: trees of more than 32 bodies keep their matrices in a per-env
// workspace in device memory (see the workspace layout below).
#define BIG_TREE (NB > 32)
#if BIG_TREE
#define MAXACT 256
#else
#define MAXACT 128
#endif

// ---- model parameters: one float buffer ----------------------------------
enum {
  P_BODY_POS = 0,
  P_BODY_IPOS = P_BODY_POS + NB * 3,
  P_MASS = P_BODY_IPOS + NB * 3,
  P_INERTIA = P_MASS + NB,
  P_IQUAT = P_INERTIA + NB * 3,
  P_ARMATURE = P_IQUAT + NB * 4,
  P_JKP = P_ARMATURE + NV,
  P_JKD = P_JKP + NDOF,
  P_TQ = P_JKD + NDOF,
  P_JRANGE = P_TQ + NDOF,
  P_CPT = P_JRANGE + NDOF * 2,
  P_CMASK = P_CPT + NB * KPTS * 3,
  P_SCPT = P_CMASK + NB * KPTS,
  P_SCRAD = P_SCPT + NB * SC * 3,
  P_SCALAR = P_SCRAD + NB,
  // scalars, offsets from P_SCALAR
  S_FRICTION = 0, S_STIFF, S_DAMP, S_DEPTHCAP, S_VREG, S_GX, S_GY, S_GZ,
  S_DT, S_RFC_SCALE, S_RFC_LIM, S_BR0, S_BR1, S_BR2, S_BR3, S_SC_K, S_SC_D,
  S_LIM_K, S_LIM_D, S_COUNT,
  P_TOTAL = P_SCALAR + S_COUNT
};

// ---- topology and config: one int buffer ---------------------------------
enum {
  I_PARENT = 0,                    // NB
  I_SUBEND = I_PARENT + NB,        // NB: subtree of b = bodies [b, end)
  I_LEVBODY = I_SUBEND + NB,       // NB: non-root bodies by depth
  I_LEVSTART = I_LEVBODY + NB,     // NB+1: level offsets into LEVBODY
  I_NLEV = I_LEVSTART + NB + 1,
  I_NPAIR = I_NLEV + 1,
  I_PAIRS = I_NPAIR + 1,           // MAXPAIR*2
  I_SELFCOL = I_PAIRS + MAXPAIR * 2,
  I_RFC, I_ACTION_V, I_META_PD, I_PD_ITERS, I_FD_ITERS, I_FRAME_SKIP,
  I_REFRESH,                       // K1g: the substep of the second exact
                                   // inverse pair, -1 for none
  I_TOTAL
};
// values of I_RFC (residual force control) and I_META_PD (gain scales);
// explicit RFC and per-dof gains run in K1f only
enum { RFC_NONE = 0, RFC_IMPLICIT = 1, RFC_EXPLICIT = 2,
       RFC_EXPLICIT_HEIGHT = 3, RFC_EXPLICIT_GROUND = 4 };
enum { GAINS_FIXED = 0, GAINS_PER_SUBSTEP = 1, GAINS_PER_DOF = 2 };

// ---- matrix workspace of one env (floats) -------------------------------
// The two preconditioners, A_pd, A_fd and the J6 / G (or K) matrices. At
// 24 bodies (195 KB) they open the block's shared memory; on a big tree
// (0.69 MB at 48 bodies, 0.80 MB at 52) they exceed a block's 227 KB and
// live in device memory, W_TOTAL floats per env, while the state, the
// per-body vectors and the PCG vectors stay in shared memory.
enum {
  W_XP = 0,
  W_XF = W_XP + NV * NV,
  W_APD = W_XF + NV * NV,
  W_AFD = W_APD + NV * NV,
  W_J6 = W_AFD + NV * NV,            // (NB*6) × NV
  W_G = W_J6 + NB * 6 * NV,          // G, then K = W·J6
  W_TOTAL = W_G + NB * 6 * NV
};

// ---- shared memory layout (floats) ----------------------------------------
enum {
  SM_QPOS = BIG_TREE ? 0 : W_TOTAL,
  SM_QVEL = SM_QPOS + NQ,
  SM_ACT = SM_QVEL + NV,
  SM_TB = SM_ACT + MAXACT,
  SM_QZ = SM_TB + NDOF,              // per body (index b), joints only
  SM_QZY = SM_QZ + NB * 4,
  SM_QLOC = SM_QZY + NB * 4,
  SM_XPOS = SM_QLOC + NB * 4,
  SM_XQUAT = SM_XPOS + NB * 3,
  SM_XIPOS = SM_XQUAT + NB * 4,
  SM_AXES = SM_XIPOS + NB * 3,
  SM_OMEGA = SM_AXES + NV * 3,
  SM_VEL = SM_OMEGA + NB * 3,
  SM_ALPHA = SM_VEL + NB * 3,
  SM_ABIAS = SM_ALPHA + NB * 3,
  SM_RTOT = SM_ABIAS + NB * 3,
  SM_IW = SM_RTOT + NB * 9,
  SM_FCON = SM_IW + NB * 9,
  SM_TCON = SM_FCON + NB * 3,
  SM_W = SM_TCON + NB * 3,
  SM_ACTIVE = SM_W + NB * 36,
  SM_PFI = SM_ACTIVE + NB,
  SM_PTI = SM_PFI + MAXPAIR * 3,
  SM_PTJ = SM_PTI + MAXPAIR * 3,
  SM_QB = SM_PTJ + MAXPAIR * 3,      // per body bias wrench [f; t]
  SM_QE = SM_QB + NB * 6,            // per body external wrench
  SM_QAPP = SM_QE + NB * 6,          // applied + limit spring forces
  SM_LIMD = SM_QAPP + NV,
  SM_ERR = SM_LIMD + NV,
  SM_KPF = SM_ERR + NV,
  SM_KDF = SM_KPF + NV,
  SM_RHS = SM_KDF + NV,
  SM_PDRHS = SM_RHS + NV,
  SM_QACCD = SM_PDRHS + NV,
  SM_X = SM_QACCD + NV,
  SM_R = SM_X + NV,
  SM_Z = SM_R + NV,
  SM_P = SM_Z + NV,
  SM_AP = SM_P + NV,
  SM_DIAG = SM_AP + NV,              // 2*NV Cholesky diagonals
  SM_SCAL = SM_DIAG + 2 * NV,        // 4 PCG scalars
  SM_TOTAL = SM_SCAL + 4,
  // K1f only, past the end of every other kernel's shared memory
  SM_VFX = SM_TOTAL,                 // 9*NB body-frame [cp|f|τ] wrenches
  SM_KSC = SM_VFX + 9 * NB,          // 2*NV per-dof kp, kd scales
  SM_TOTAL_F = SM_KSC + 2 * NV
};

// ---- small vector helpers --------------------------------------------------
HD void qmul(const float* a, const float* b, float* o) {
  float w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  float x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  float y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  float z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

HD void cross3(const float* a, const float* b, float* o) {
  float x = a[1] * b[2] - a[2] * b[1];
  float y = a[2] * b[0] - a[0] * b[2];
  float z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}

// R(q) v = v + 2 (w·u×v + u×(u×v))
HD void qrot(const float* q, const float* v, float* o) {
  float uv[3], uuv[3];
  cross3(q + 1, v, uv);
  cross3(q + 1, uv, uuv);
  for (int k = 0; k < 3; ++k) o[k] = v[k] + 2.0f * (q[0] * uv[k] + uuv[k]);
}

HD void qnormalize(float* q) {
  float sq = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  float n = sq > 1e-24f ? sqrtf(sq) : 1e-12f;
  for (int k = 0; k < 4; ++k) q[k] = q[k] / n;
}

HD void qtomat(const float* q, float* m) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  float xx = x * x, yy = y * y, zz = z * z;
  float wx = w * x, wy = w * y, wz = w * z;
  float xy = x * y, xz = x * z, yz = y * z;
  m[0] = 1 - 2 * (yy + zz); m[1] = 2 * (xy - wz); m[2] = 2 * (xz + wy);
  m[3] = 2 * (xy + wz); m[4] = 1 - 2 * (xx + zz); m[5] = 2 * (yz - wx);
  m[6] = 2 * (xz - wy); m[7] = 2 * (yz + wx); m[8] = 1 - 2 * (xx + yy);
}

HD float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// wrap to (-pi, pi], round half to even like torch.round
HD float wrap_pi(float x) {
  const float two_pi = 6.283185307179586f;
  return x - two_pi * rintf(x / two_pi);
}

// deepest body of dofs i, j when one body is an ancestor of the other
// (their Jacobian columns overlap on its subtree), else -1
HD int related(int bi, int bj, const int* I) {
  if (bi <= bj && bj < I[I_SUBEND + bi]) return bj;
  if (bj <= bi && bi < I[I_SUBEND + bj]) return bi;
  return -1;
}

HD int dof_body(int j) { return j < 6 ? 0 : 1 + (j - 6) / 3; }

HD void tri_index(int t, int* i, int* j) {
  int r = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while (r * (r + 1) / 2 > t) --r;
  while ((r + 1) * (r + 2) / 2 <= t) ++r;
  *i = r;
  *j = t - r * (r + 1) / 2;
}

// y = A x over the rows owned by this thread
HD void matvec(const float* A, const float* x, float* y, int tid, int nth) {
  for (int i = tid; i < NV; i += nth) {
    float s = 0.0f;
    for (int k = 0; k < NV; ++k) s += A[i * NV + k] * x[k];
    y[i] = s;
  }
}

HD float dot75(const float* a, const float* b) {
  float s = 0.0f;
  for (int k = 0; k < NV; ++k) s += a[k] * b[k];
  return s;
}

// PCG with warm start x0 = X b (X ≈ A⁻¹): the solution lands in SM_X
HD void pcg(float* sm, const float* A, const float* X, const float* b,
            int iters, int tid, int nth) {
  float* x = sm + SM_X;
  float* r = sm + SM_R;
  float* z = sm + SM_Z;
  float* p = sm + SM_P;
  float* Ap = sm + SM_AP;
  float* scal = sm + SM_SCAL;
  matvec(X, b, x, tid, nth);
  SYNC();
  for (int i = tid; i < NV; i += nth) {
    float s = 0.0f;
    for (int k = 0; k < NV; ++k) s += A[i * NV + k] * x[k];
    r[i] = b[i] - s;
  }
  SYNC();
  matvec(X, r, z, tid, nth);
  SYNC();
  if (tid == 0) scal[0] = dot75(r, z);
  for (int i = tid; i < NV; i += nth) p[i] = z[i];
  SYNC();
  for (int it = 0; it < iters; ++it) {
    matvec(A, p, Ap, tid, nth);
    SYNC();
    if (tid == 0) scal[1] = scal[0] / (dot75(p, Ap) + 1e-12f);
    SYNC();
    float alpha = scal[1];
    for (int i = tid; i < NV; i += nth) {
      x[i] += alpha * p[i];
      r[i] -= alpha * Ap[i];
    }
    SYNC();
    matvec(X, r, z, tid, nth);
    SYNC();
    if (tid == 0) {
      float rz_new = dot75(r, z);
      scal[2] = rz_new / (scal[0] + 1e-12f);
      scal[0] = rz_new;
    }
    SYNC();
    float beta = scal[2];
    for (int i = tid; i < NV; i += nth) p[i] = z[i] + beta * p[i];
    SYNC();
  }
}

// Exact inverses of A_pd -> Xp and A_fd -> Xf (substep 0): right-looking
// Cholesky of both in place in Xp / Xf, lower-triangular inverses Y into
// the J6 / G workspace, then X = Yᵀ Y.
HD void exact_inverses(float* sm, float* ws, int tid, int nth) {
  float* diag = sm + SM_DIAG;
  for (int t = tid; t < 2 * NV * NV; t += nth) {
    int m = t / (NV * NV), e = t % (NV * NV);
    ws[(m ? W_XF : W_XP) + e] = ws[(m ? W_AFD : W_APD) + e];
  }
  SYNC();
  for (int k = 0; k < NV; ++k) {
    int n = NV - k;
    for (int t = tid; t < 2 * n; t += nth) {
      int m = t / n, i = k + t % n;
      float* A = ws + (m ? W_XF : W_XP);
      float d = sqrtf(fmaxf(A[k * NV + k], 1e-12f));
      if (i == k) diag[m * NV + k] = d;
      else A[i * NV + k] = A[i * NV + k] / d;
    }
    SYNC();
    int nt = (n - 1) * n / 2;     // pairs k < j <= i < NV
    for (int t = tid; t < 2 * nt; t += nth) {
      int m = t / nt, ii, jj;
      tri_index(t % nt, &ii, &jj);
      int i = k + 1 + ii, j = k + 1 + jj;
      float* A = ws + (m ? W_XF : W_XP);
      A[i * NV + j] -= A[i * NV + k] * A[j * NV + k];
    }
    SYNC();
  }
  // Y = L⁻¹, column by column (forward substitution against e_c)
  for (int t = tid; t < 2 * NV; t += nth) {
    int m = t / NV, c = t % NV;
    const float* L = ws + (m ? W_XF : W_XP);
    float* Y = ws + (m ? W_G : W_J6);
    const float* dg = diag + m * NV;
    for (int i = c; i < NV; ++i) {
      float s = (i == c) ? 1.0f : 0.0f;
      for (int k = c; k < i; ++k) s -= L[i * NV + k] * Y[k * NV + c];
      Y[i * NV + c] = s / dg[i];
    }
  }
  SYNC();
  for (int t = tid; t < 2 * NTRI; t += nth) {
    int m = t / NTRI, i, j;
    tri_index(t % NTRI, &i, &j);
    const float* Y = ws + (m ? W_G : W_J6);
    float* X = ws + (m ? W_XF : W_XP);
    float s = 0.0f;
    for (int k = i; k < NV; ++k) s += Y[k * NV + i] * Y[k * NV + j];
    X[i * NV + j] = s;
    X[j * NV + i] = s;
  }
  SYNC();
}

// Which substeps a launch runs: all (K1), substep 0 (K2 head) or
// substeps 1.. (K2 tail).
enum { PART_FULL = 0, PART_HEAD = 1, PART_TAIL = 2 };

// Substeps of one env. The head stores Xp, Xf to X (env-major, Xp then
// Xf); the tail loads them from X. The env's model is row seq_idx[env] of
// the library Plib (row 0 without seq_idx). `ws` is the env's matrix
// workspace: `sm` itself at 24 bodies, its slice of device memory on a
// big tree. EXT (K1f) reads the explicit wrench `vfx_in` (B, 9·NB) and
// the per-dof gain scales `ksc_in` (B, 2, NV) where the int table asks
// for them; without EXT both are null and unread.
template <bool EXT>
HD void control_step_env(int env, int tid, int nth, float* sm, float* ws,
                         const float* __restrict__ Plib,
                         const int* __restrict__ seq_idx,
                         const int* __restrict__ I,
                         const float* __restrict__ qpos_in,
                         const float* __restrict__ qvel_in,
                         const float* __restrict__ act_in,
                         const float* __restrict__ tb_in,
                         float* __restrict__ qpos_out,
                         float* __restrict__ qvel_out, int act_dim,
                         float rfc_rate, int part, float* X,
                         const float* __restrict__ vfx_in,
                         const float* __restrict__ ksc_in) {
  const float* __restrict__ P =
      Plib + (seq_idx ? (size_t)seq_idx[env] * P_TOTAL : (size_t)0);
  const float* S = P + P_SCALAR;
  const float dt = S[S_DT];
  const int fs = I[I_FRAME_SKIP];
  const int rfc = I[I_RFC];
  const int meta = I[I_META_PD] == GAINS_PER_SUBSTEP;
  const bool per_dof = EXT && I[I_META_PD] == GAINS_PER_DOF;
  // the action columns kept in SM_ACT after the PD targets: implicit RFC
  // (6), then the per-substep meta-PD scales
  const int vf_dim = rfc == RFC_IMPLICIT ? 6 : 0;
  float* qpos = sm + SM_QPOS;
  float* qvel = sm + SM_QVEL;
  float* act = sm + SM_ACT;
  float* xpos = sm + SM_XPOS;
  float* xquat = sm + SM_XQUAT;
  float* xipos = sm + SM_XIPOS;
  float* axes = sm + SM_AXES;
  float* omega = sm + SM_OMEGA;
  float* vel = sm + SM_VEL;
  float* alpha = sm + SM_ALPHA;
  float* abias = sm + SM_ABIAS;
  float* J6 = ws + W_J6;
  float* G = ws + W_G;

  for (int t = tid; t < NQ; t += nth) qpos[t] = qpos_in[(size_t)env * NQ + t];
  for (int t = tid; t < NV; t += nth) qvel[t] = qvel_in[(size_t)env * NV + t];
  if (EXT) {
    // K1f: the wrench and per-dof scale columns come prepared in vfx_in /
    // ksc_in; keep the PD targets and the per-substep meta-PD columns
    int meta_cols = meta ? 2 * fs : per_dof ? 2 * NDOF : 0;
    int skip = rfc >= RFC_EXPLICIT ? act_dim - NDOF - meta_cols : 0;
    int keep = act_dim - skip - (per_dof ? 2 * NDOF : 0);
    for (int t = tid; t < keep; t += nth)
      act[t] = act_in[(size_t)env * act_dim + (t < NDOF ? t : t + skip)];
    if (rfc >= RFC_EXPLICIT)
      for (int t = tid; t < 9 * NB; t += nth)
        sm[SM_VFX + t] = vfx_in[(size_t)env * 9 * NB + t];
    if (per_dof)
      for (int t = tid; t < 2 * NV; t += nth)
        sm[SM_KSC + t] = ksc_in[(size_t)env * 2 * NV + t];
  } else {
    for (int t = tid; t < act_dim; t += nth)
      act[t] = act_in[(size_t)env * act_dim + t];
  }
  for (int t = tid; t < NDOF; t += nth)
    sm[SM_TB + t] = tb_in[(size_t)env * NDOF + t];
  if (part == PART_TAIL)
    for (int t = tid; t < 2 * NV * NV; t += nth)
      ws[W_XP + t] = X[(size_t)env * 2 * NV * NV + t];
  SYNC();

  const int s_begin = part == PART_TAIL ? 1 : 0;
  const int s_end = part == PART_HEAD ? 1 : fs;
#pragma unroll 1
  for (int s = s_begin; s < s_end; ++s) {
    const float ks = meta ? clampf(act[NDOF + vf_dim + s] + 1.0f, 0.f, 10.f)
                          : 1.0f;
    const float ds = meta
        ? clampf(act[NDOF + vf_dim + fs + s] + 1.0f, 0.f, 10.f) : 1.0f;

    // -- A: joint quats, root, per-dof limits and PD errors, RFC wrench --
    for (int t = tid; t < NB + NV + 1; t += nth) {
      if (t == 0) {
        for (int k = 0; k < 3; ++k) xpos[k] = qpos[k];
        for (int k = 0; k < 4; ++k) xquat[k] = qpos[3 + k];
        qnormalize(xquat);
      } else if (t < NB) {
        const float* e = qpos + 7 + 3 * (t - 1);
        float cz = cosf(e[0] * 0.5f), sz = sinf(e[0] * 0.5f);
        float cy = cosf(e[1] * 0.5f), sy = sinf(e[1] * 0.5f);
        float cx = cosf(e[2] * 0.5f), sx = sinf(e[2] * 0.5f);
        float qz[4] = {cz, 0.f, 0.f, sz}, qy[4] = {cy, 0.f, sy, 0.f};
        float qx[4] = {cx, sx, 0.f, 0.f}, qzy[4];
        qmul(qz, qy, qzy);
        qmul(qzy, qx, sm + SM_QLOC + 4 * t);
        for (int k = 0; k < 4; ++k) {
          sm[SM_QZ + 4 * t + k] = qz[k];
          sm[SM_QZY + 4 * t + k] = qzy[k];
        }
      } else if (t < NB + NV) {
        int j = t - NB;
        if (j < 6) {
          sm[SM_ERR + j] = 0.f; sm[SM_KPF + j] = 0.f; sm[SM_KDF + j] = 0.f;
          sm[SM_LIMD + j] = 0.f;
        } else {
          int d = j - 6;
          float q = qpos[7 + d];
          float lo = P[P_JRANGE + 2 * d], hi = P[P_JRANGE + 2 * d + 1];
          float below = fmaxf(lo - q, 0.f), above = fmaxf(q - hi, 0.f);
          float out = (below > 0.f || above > 0.f) ? 1.f : 0.f;
          sm[SM_QAPP + j] = S[S_LIM_K] * (below - above);
          sm[SM_LIMD + j] = out * S[S_LIM_D];
          float base = I[I_ACTION_V] == 1 ? q + wrap_pi(sm[SM_TB + d] - q)
                                          : 0.f;
          float target = base + act[d];
          sm[SM_ERR + j] = q + qvel[j] * dt - target;
          sm[SM_KPF + j] = P[P_JKP + d] * (per_dof ? sm[SM_KSC + j] : ks);
          sm[SM_KDF + j] = P[P_JKD + d]
                           * (per_dof ? sm[SM_KSC + NV + j] : ds);
        }
      } else {
        // implicit residual force: heading-rotated linear part, clipped
        float vf[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (vf_dim) {
          float sc = S[S_RFC_SCALE] * rfc_rate;
          for (int k = 0; k < 6; ++k) vf[k] = act[NDOF + k] * sc;
          float br[4] = {S[S_BR0], S[S_BR1], S[S_BR2], S[S_BR3]};
          float n2 = fmaxf(br[0] * br[0] + br[1] * br[1] + br[2] * br[2]
                           + br[3] * br[3], 1.17549435e-38f);
          float bi[4] = {br[0] / n2, -br[1] / n2, -br[2] / n2, -br[3] / n2};
          float cq[4], lin[3];
          qmul(qpos + 3, bi, cq);
          cq[1] = 0.f; cq[2] = 0.f;
          qnormalize(cq);
          qrot(cq, vf, lin);
          for (int k = 0; k < 3; ++k) vf[k] = lin[k];
          for (int k = 0; k < 6; ++k)
            vf[k] = clampf(vf[k], -S[S_RFC_LIM], S[S_RFC_LIM]);
        }
        for (int k = 0; k < 6; ++k) sm[SM_QAPP + k] = vf[k];
      }
    }
    SYNC();

    // -- B: forward kinematics, one tree level at a time ----------------
    for (int lv = 0; lv < I[I_NLEV]; ++lv) {
      int a = I[I_LEVSTART + lv], e = I[I_LEVSTART + lv + 1];
      for (int t = a + tid; t < e; t += nth) {
        int b = I[I_LEVBODY + t], p = I[I_PARENT + b];
        float off[3];
        qrot(xquat + 4 * p, P + P_BODY_POS + 3 * b, off);
        for (int k = 0; k < 3; ++k) xpos[3 * b + k] = xpos[3 * p + k] + off[k];
        qmul(xquat + 4 * p, sm + SM_QLOC + 4 * b, xquat + 4 * b);
      }
      SYNC();
    }

    // -- C: COMs, inertia frames, dof axes, root velocity ---------------
    for (int t = tid; t < NB + NV + 1; t += nth) {
      if (t < NB) {
        int b = t;
        float off[3], q[4];
        qrot(xquat + 4 * b, P + P_BODY_IPOS + 3 * b, off);
        for (int k = 0; k < 3; ++k) xipos[3 * b + k] = xpos[3 * b + k] + off[k];
        qmul(xquat + 4 * b, P + P_IQUAT + 4 * b, q);
        float* R = sm + SM_RTOT + 9 * b;
        qtomat(q, R);
        const float* In = P + P_INERTIA + 3 * b;
        float* Iw = sm + SM_IW + 9 * b;
        for (int r = 0; r < 3; ++r)
          for (int c = 0; c < 3; ++c) {
            float s = 0.f;
            for (int k = 0; k < 3; ++k) s += R[3 * r + k] * In[k] * R[3 * c + k];
            Iw[3 * r + c] = s;
          }
      } else if (t < NB + NV) {
        int j = t - NB;
        float* ax = axes + 3 * j;
        if (j < 3) {
          for (int k = 0; k < 3; ++k) ax[k] = (k == j) ? 1.f : 0.f;
        } else if (j < 6) {
          float R0[9];
          qtomat(xquat, R0);
          for (int k = 0; k < 3; ++k) ax[k] = R0[3 * k + (j - 3)];
        } else {
          int b = dof_body(j), kk = (j - 6) % 3;
          const float* qp = xquat + 4 * I[I_PARENT + b];
          float unit[3] = {0.f, 0.f, 0.f}, q[4];
          if (kk == 0) {
            unit[2] = 1.f;
            qrot(qp, unit, ax);
          } else {
            unit[kk == 1 ? 1 : 0] = 1.f;
            qmul(qp, sm + (kk == 1 ? SM_QZ : SM_QZY) + 4 * b, q);
            qrot(q, unit, ax);
          }
        }
      } else {
        float R0[9];
        qtomat(xquat, R0);
        for (int k = 0; k < 3; ++k) {
          omega[k] = R0[3 * k] * qvel[3] + R0[3 * k + 1] * qvel[4]
                     + R0[3 * k + 2] * qvel[5];
          vel[k] = qvel[k];
          alpha[k] = 0.f;
          abias[k] = 0.f;
        }
      }
    }
    SYNC();

    // -- D: velocities and bias accelerations, level by level -----------
    for (int lv = 0; lv < I[I_NLEV]; ++lv) {
      int a = I[I_LEVSTART + lv], e = I[I_LEVSTART + lv + 1];
      for (int t = a + tid; t < e; t += nth) {
        int b = I[I_LEVBODY + t], p = I[I_PARENT + b];
        const float* az = axes + 3 * (6 + 3 * (b - 1));
        const float* ay = az + 3;
        const float* ax = az + 6;
        const float* dq = qvel + 6 + 3 * (b - 1);
        const float* w0 = omega + 3 * p;
        float w1[3], w2[3], c0[3], c1[3], c2[3], d[3], cv[3], ca[3], cw[3];
        for (int k = 0; k < 3; ++k) w1[k] = w0[k] + az[k] * dq[0];
        for (int k = 0; k < 3; ++k) w2[k] = w1[k] + ay[k] * dq[1];
        cross3(w0, az, c0);
        cross3(w1, ay, c1);
        cross3(w2, ax, c2);
        for (int k = 0; k < 3; ++k) d[k] = xpos[3 * b + k] - xpos[3 * p + k];
        cross3(w0, d, cv);
        cross3(alpha + 3 * p, d, ca);
        cross3(w0, cv, cw);
        for (int k = 0; k < 3; ++k) {
          omega[3 * b + k] = w2[k] + ax[k] * dq[2];
          alpha[3 * b + k] = alpha[3 * p + k] + c0[k] * dq[0] + c1[k] * dq[1]
                             + c2[k] * dq[2];
          vel[3 * b + k] = vel[3 * p + k] + cv[k];
          abias[3 * b + k] = abias[3 * p + k] + ca[k] + cw[k];
        }
      }
      SYNC();
    }

    // -- E: bias wrenches, ground contacts, self-collision pairs, J6, G --
    const int npair = I[I_NPAIR];
    for (int t = tid; t < 2 * NB + npair + NB * 6 * NV; t += nth) {
      if (t < NB) {
        int b = t;
        const float* w = omega + 3 * b;
        const float* al = alpha + 3 * b;
        const float* Iw = sm + SM_IW + 9 * b;
        float r[3], c1[3], c2[3], c3[3], acom[3], Ia[3], Iwv[3], cw[3];
        for (int k = 0; k < 3; ++k) r[k] = xipos[3 * b + k] - xpos[3 * b + k];
        cross3(al, r, c1);
        cross3(w, r, c2);
        cross3(w, c2, c3);
        for (int k = 0; k < 3; ++k)
          acom[k] = abias[3 * b + k] + c1[k] + c3[k];
        for (int k = 0; k < 3; ++k) {
          Ia[k] = Iw[3 * k] * al[0] + Iw[3 * k + 1] * al[1] + Iw[3 * k + 2] * al[2];
          Iwv[k] = Iw[3 * k] * w[0] + Iw[3 * k + 1] * w[1] + Iw[3 * k + 2] * w[2];
        }
        cross3(w, Iwv, cw);
        float m = P[P_MASS + b];
        float* QB = sm + SM_QB + 6 * b;
        for (int k = 0; k < 3; ++k) {
          QB[k] = m * (acom[k] - S[S_GX + k]);
          QB[3 + k] = Ia[k] + cw[k];
        }
      } else if (t < 2 * NB) {
        int b = t - NB;
        const float* q = xquat + 4 * b;
        float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
        float ox = omega[3 * b], oy = omega[3 * b + 1], oz = omega[3 * b + 2];
        float sfn = 0.f, sfnrx = 0.f, sfnry = 0.f, sa = 0.f, sb = 0.f;
        float sarx = 0.f, sary = 0.f, sarz = 0.f, sbrx = 0.f, sbry = 0.f;
        float arz2 = 0.f, arx2 = 0.f, ary2 = 0.f, arxz = 0.f, aryz = 0.f;
        float brx2 = 0.f, bry2 = 0.f, brxy = 0.f, nact = 0.f;
        for (int p = 0; p < KPTS; ++p) {
          const float* cp = P + P_CPT + 3 * (b * KPTS + p);
          float cpx = cp[0], cpy = cp[1], cpz = cp[2];
          float tx = 2.0f * (qy * cpz - qz * cpy);
          float ty = 2.0f * (qz * cpx - qx * cpz);
          float tz = 2.0f * (qx * cpy - qy * cpx);
          float dx = cpx + qw * tx + (qy * tz - qz * ty);
          float dy = cpy + qw * ty + (qz * tx - qx * tz);
          float dz = cpz + qw * tz + (qx * ty - qy * tx);
          float wpz = xpos[3 * b + 2] + dz;
          float vpx = vel[3 * b] + (oy * dz - oz * dy);
          float vpy = vel[3 * b + 1] + (oz * dx - ox * dz);
          float active = (wpz < 0.f ? 1.f : 0.f) * P[P_CMASK + b * KPTS + p];
          float pen = fminf(fmaxf(-wpz, 0.f), S[S_DEPTHCAP]);
          float fn = S[S_STIFF] * pen * active;
          float vt = sqrtf(vpx * vpx + vpy * vpy + 1e-12f);
          float bb = S[S_DAMP] * active;
          float aa = active * fminf(S[S_FRICTION] * fn / fmaxf(vt, S[S_VREG]),
                                    2000.f);
          float rx = xpos[3 * b] + dx - xipos[3 * b];
          float ry = xpos[3 * b + 1] + dy - xipos[3 * b + 1];
          float rz = wpz - xipos[3 * b + 2];
          nact += active;
          sfn += fn; sfnrx += fn * rx; sfnry += fn * ry;
          sa += aa; sb += bb;
          sarx += aa * rx; sary += aa * ry; sarz += aa * rz;
          sbrx += bb * rx; sbry += bb * ry;
          arz2 += aa * rz * rz; arx2 += aa * rx * rx; ary2 += aa * ry * ry;
          arxz += aa * rx * rz; aryz += aa * ry * rz;
          brx2 += bb * rx * rx; bry2 += bb * ry * ry; brxy += bb * rx * ry;
        }
        float* F = sm + SM_FCON + 3 * b;
        float* T = sm + SM_TCON + 3 * b;
        F[0] = 0.f; F[1] = 0.f; F[2] = sfn;
        T[0] = sfnry; T[1] = -sfnrx; T[2] = 0.f;
        float* W = sm + SM_W + 36 * b;
        float Wll[9] = {sa, 0.f, 0.f, 0.f, sa, 0.f, 0.f, 0.f, sb};
        float Wla[9] = {0.f, sarz, -sary, -sarz, 0.f, sarx, sbry, -sbrx, 0.f};
        float Waa[9] = {arz2 + bry2, -brxy, -arxz, -brxy, arz2 + brx2, -aryz,
                        -arxz, -aryz, arx2 + ary2};
        for (int r = 0; r < 3; ++r)
          for (int c = 0; c < 3; ++c) {
            W[6 * r + c] = Wll[3 * r + c];
            W[6 * r + 3 + c] = Wla[3 * r + c];
            W[6 * (3 + r) + c] = Wla[3 * c + r];
            W[6 * (3 + r) + 3 + c] = Waa[3 * r + c];
          }
        sm[SM_ACTIVE + b] = nact;
      } else if (t < 2 * NB + npair) {
        int pr = t - 2 * NB;
        int bi = I[I_PAIRS + 2 * pr], bj = I[I_PAIRS + 2 * pr + 1];
        float Fi[3] = {0.f, 0.f, 0.f}, Ti[3] = {0.f, 0.f, 0.f};
        float Tj[3] = {0.f, 0.f, 0.f};
        if (I[I_SELFCOL]) {
          float wi[SC][3], wj[SC][3];
          for (int s2 = 0; s2 < SC; ++s2) {
            float o[3];
            qrot(xquat + 4 * bi, P + P_SCPT + 3 * (bi * SC + s2), o);
            for (int k = 0; k < 3; ++k) wi[s2][k] = xpos[3 * bi + k] + o[k];
            qrot(xquat + 4 * bj, P + P_SCPT + 3 * (bj * SC + s2), o);
            for (int k = 0; k < 3; ++k) wj[s2][k] = xpos[3 * bj + k] + o[k];
          }
          float rsum = P[P_SCRAD + bi] + P[P_SCRAD + bj];
          for (int a = 0; a < SC; ++a)
            for (int c = 0; c < SC; ++c) {
              float diff[3];
              for (int k = 0; k < 3; ++k) diff[k] = wi[a][k] - wj[c][k];
              float dist = sqrtf(diff[0] * diff[0] + diff[1] * diff[1]
                                 + diff[2] * diff[2] + 1e-12f);
              float depth = rsum - dist;
              if (!(depth > 0.f)) continue;
              float n[3], li[3], lj[3], ci[3], cj[3], vrel[3];
              for (int k = 0; k < 3; ++k) {
                n[k] = diff[k] / dist;
                li[k] = wi[a][k] - xpos[3 * bi + k];
                lj[k] = wj[c][k] - xpos[3 * bj + k];
              }
              cross3(omega + 3 * bi, li, ci);
              cross3(omega + 3 * bj, lj, cj);
              for (int k = 0; k < 3; ++k)
                vrel[k] = (vel[3 * bi + k] + ci[k]) - (vel[3 * bj + k] + cj[k]);
              float vn = vrel[0] * n[0] + vrel[1] * n[1] + vrel[2] * n[2];
              float fn = fmaxf(S[S_SC_K] * depth - S[S_SC_D] * vn, 0.f);
              float Fp[3], mFp[3], ri[3], rj[3], a1[3], a2[3];
              for (int k = 0; k < 3; ++k) {
                Fp[k] = fn * n[k];
                mFp[k] = -Fp[k];
                float pt = 0.5f * (wi[a][k] + wj[c][k]);
                ri[k] = pt - xipos[3 * bi + k];
                rj[k] = pt - xipos[3 * bj + k];
              }
              cross3(ri, Fp, a1);
              cross3(rj, mFp, a2);
              for (int k = 0; k < 3; ++k) {
                Fi[k] += Fp[k];
                Ti[k] += a1[k];
                Tj[k] += a2[k];
              }
            }
        }
        for (int k = 0; k < 3; ++k) {
          sm[SM_PFI + 3 * pr + k] = Fi[k];
          sm[SM_PTI + 3 * pr + k] = Ti[k];
          sm[SM_PTJ + 3 * pr + k] = Tj[k];
        }
      } else {
        int e = t - 2 * NB - npair;
        int row = e / NV, j = e % NV;
        int b = row / 6, k = row % 6;
        int bj = dof_body(j);
        float jv = 0.f, gv = 0.f;
        if (bj <= b && b < I[I_SUBEND + bj]) {
          const float* a = axes + 3 * j;
          if (k < 3) {
            if (j < 3) {
              jv = a[k];
            } else {
              float r[3], c[3];
              for (int q = 0; q < 3; ++q) r[q] = xipos[3 * b + q] - xpos[3 * bj + q];
              cross3(a, r, c);
              jv = c[k];
            }
            gv = sqrtf(P[P_MASS + b]) * jv;
          } else if (j >= 3) {
            int c = k - 3;
            const float* R = sm + SM_RTOT + 9 * b;
            jv = a[c];
            gv = sqrtf(P[P_INERTIA + 3 * b + c])
                 * (R[c] * a[0] + R[3 + c] * a[1] + R[6 + c] * a[2]);
          }
        }
        J6[row * NV + j] = jv;
        G[row * NV + j] = gv;
      }
    }
    SYNC();

    // -- F: per-body external wrench (contacts, pairs, contact damping) --
    for (int t = tid; t < NB; t += nth) {
      int b = t;
      float F[3], T[3];
      for (int k = 0; k < 3; ++k) {
        F[k] = sm[SM_FCON + 3 * b + k];
        T[k] = sm[SM_TCON + 3 * b + k];
      }
      for (int pr = 0; pr < npair; ++pr) {
        int bi = I[I_PAIRS + 2 * pr], bj = I[I_PAIRS + 2 * pr + 1];
        for (int k = 0; k < 3; ++k) {
          if (bi == b) {
            F[k] += sm[SM_PFI + 3 * pr + k];
            T[k] += sm[SM_PTI + 3 * pr + k];
          }
          if (bj == b) {
            F[k] -= sm[SM_PFI + 3 * pr + k];
            T[k] += sm[SM_PTJ + 3 * pr + k];
          }
        }
      }
      if (EXT && rfc >= RFC_EXPLICIT) {
        // explicit RFC: the body-frame wrench rotated by the body's
        // orientation, gated, applied at xpos + cp (engine.assemble)
        const float* w = sm + SM_VFX + 9 * b;
        const float* q = xquat + 4 * b;
        float cpw[3], fw[3], tw[3], r[3], c[3];
        qrot(q, w, cpw);
        qrot(q, w + 3, fw);
        qrot(q, w + 6, tw);
        float g = 1.f;
        if (rfc == RFC_EXPLICIT_HEIGHT)
          g = xpos[3 * b + 2] <= 0.12f ? 1.f : 0.f;
        else if (rfc == RFC_EXPLICIT_GROUND)
          g = sm[SM_ACTIVE + b] > 0.f ? 1.f : 0.f;   // the contact test
        for (int k = 0; k < 3; ++k) {
          fw[k] *= g;
          tw[k] *= g;
          r[k] = xpos[3 * b + k] + cpw[k] - xipos[3 * b + k];
        }
        cross3(r, fw, c);
        for (int k = 0; k < 3; ++k) {
          F[k] += fw[k];
          T[k] += c[k] + tw[k];
        }
      }
      float Wv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (sm[SM_ACTIVE + b] > 0.f) {
        float r[3], c[3], v6[6];
        for (int k = 0; k < 3; ++k) r[k] = xipos[3 * b + k] - xpos[3 * b + k];
        cross3(omega + 3 * b, r, c);
        for (int k = 0; k < 3; ++k) {
          v6[k] = vel[3 * b + k] + c[k];
          v6[3 + k] = omega[3 * b + k];
        }
        const float* W = sm + SM_W + 36 * b;
        for (int r2 = 0; r2 < 6; ++r2) {
          float s2 = 0.f;
          for (int k = 0; k < 6; ++k) s2 += W[6 * r2 + k] * v6[k];
          Wv[r2] = s2;
        }
      }
      float* QE = sm + SM_QE + 6 * b;
      for (int k = 0; k < 3; ++k) {
        QE[k] = F[k] - Wv[k];
        QE[3 + k] = T[k] - Wv[3 + k];
      }
    }
    SYNC();

    // -- G: generalized forces per dof; M into A_pd and A_fd -------------
    for (int t = tid; t < NV + NTRI; t += nth) {
      if (t < NV) {
        int j = t, bj = dof_body(j);
        float c = 0.f, fx = 0.f;
        for (int row = 6 * bj; row < 6 * I[I_SUBEND + bj]; ++row) {
          float jv = J6[row * NV + j];
          c += jv * sm[SM_QB + row];
          fx += jv * sm[SM_QE + row];
        }
        sm[SM_RHS + j] = sm[SM_QAPP + j] + fx
                         - sm[SM_LIMD + j] * qvel[j] - c;
        sm[SM_PDRHS + j] = -c - sm[SM_KPF + j] * sm[SM_ERR + j]
                           - sm[SM_KDF + j] * qvel[j];
      } else {
        int i, j;
        tri_index(t - NV, &i, &j);
        int d = related(dof_body(i), dof_body(j), I);
        float m = 0.f;
        if (d >= 0)
          for (int row = 6 * d; row < 6 * I[I_SUBEND + d]; ++row)
            m += G[row * NV + i] * G[row * NV + j];
        if (i == j) m += P[P_ARMATURE + i];
        float apd = (i == j) ? m + sm[SM_KDF + i] * dt : m;
        ws[W_APD + i * NV + j] = apd;
        ws[W_APD + j * NV + i] = apd;
        ws[W_AFD + i * NV + j] = m;
        ws[W_AFD + j * NV + i] = m;
      }
    }
    SYNC();

    // -- H: K = W·J6 for bodies in contact (into the G workspace) -------
    for (int t = tid; t < NB * 6 * NV; t += nth) {
      int row = t / NV, j = t % NV, b = row / 6, c = row % 6;
      if (!(sm[SM_ACTIVE + b] > 0.f)) continue;
      const float* W = sm + SM_W + 36 * b + 6 * c;
      float s2 = 0.f;
      for (int k = 0; k < 6; ++k) s2 += W[k] * J6[(6 * b + k) * NV + j];
      G[row * NV + j] = s2;
    }
    SYNC();

    // -- I: A_fd = M + dt·(CD + diag(limit damping)) ---------------------
    for (int t = tid; t < NTRI; t += nth) {
      int i, j;
      tri_index(t, &i, &j);
      int d = related(dof_body(i), dof_body(j), I);
      float cd = 0.f;
      if (d >= 0)
        for (int b = d; b < I[I_SUBEND + d]; ++b) {
          if (!(sm[SM_ACTIVE + b] > 0.f)) continue;
          for (int k = 0; k < 6; ++k)
            cd += J6[(6 * b + k) * NV + i] * G[(6 * b + k) * NV + j];
        }
      if (i == j) cd += sm[SM_LIMD + i];
      float v = ws[W_AFD + i * NV + j] + dt * cd;
      ws[W_AFD + i * NV + j] = v;
      ws[W_AFD + j * NV + i] = v;
    }
    SYNC();

    // the inverses overwrite J6 and G, which nothing reads again before
    // the next substep's phase E rebuilds them: so also at I_REFRESH
    if (s == 0 || s == I[I_REFRESH]) exact_inverses(sm, ws, tid, nth);

    // -- stable PD: q̈_des, torques, forward dynamics -------------------
    pcg(sm, ws + W_APD, ws + W_XP, sm + SM_PDRHS, I[I_PD_ITERS], tid, nth);
    for (int t = tid; t < NV; t += nth) sm[SM_QACCD + t] = sm[SM_X + t];
    SYNC();
    for (int t = tid; t < NDOF; t += nth) {
      int j = 6 + t;
      float tau = -sm[SM_KPF + j] * sm[SM_ERR + j]
                  - sm[SM_KDF + j] * (qvel[j] + sm[SM_QACCD + j] * dt);
      float lim = P[P_TQ + t];
      sm[SM_RHS + j] += clampf(tau, -lim, lim);
    }
    SYNC();
    pcg(sm, ws + W_AFD, ws + W_XF, sm + SM_RHS, I[I_FD_ITERS], tid, nth);

    // -- integrate: semi-implicit Euler, quaternion root ----------------
    for (int t = tid; t < NV; t += nth) qvel[t] = qvel[t] + dt * sm[SM_X + t];
    SYNC();
    for (int t = tid; t < NDOF + 1; t += nth) {
      if (t < NDOF) {
        qpos[7 + t] = qpos[7 + t] + dt * qvel[6 + t];
      } else {
        for (int k = 0; k < 3; ++k) qpos[k] = qpos[k] + dt * qvel[k];
        float rv[3] = {qvel[3] * dt, qvel[4] * dt, qvel[5] * dt};
        float sq = rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2];
        float dq[4];
        if (sq > 1e-16f) {
          float ang = sqrtf(sq), h = 0.5f * ang, kk = sinf(h) / ang;
          dq[0] = cosf(h); dq[1] = rv[0] * kk; dq[2] = rv[1] * kk;
          dq[3] = rv[2] * kk;
        } else {
          float kk = 0.5f - sq / 48.0f;
          dq[0] = 1.0f; dq[1] = rv[0] * kk; dq[2] = rv[1] * kk;
          dq[3] = rv[2] * kk;
        }
        float q[4];
        qmul(qpos + 3, dq, q);
        qnormalize(q);
        for (int k = 0; k < 4; ++k) qpos[3 + k] = q[k];
      }
    }
    SYNC();
  }

  if (part == PART_HEAD)
    for (int t = tid; t < 2 * NV * NV; t += nth)
      X[(size_t)env * 2 * NV * NV + t] = ws[W_XP + t];
  for (int t = tid; t < NQ; t += nth) qpos_out[(size_t)env * NQ + t] = qpos[t];
  for (int t = tid; t < NV; t += nth) qvel_out[(size_t)env * NV + t] = qvel[t];
}

// ---- entry points (plain C interface for ctypes) --------------------------

extern "C" int uhc_control_step_layout(int* out) {
  out[0] = P_TOTAL;
  out[1] = I_TOTAL;
  out[2] = SM_TOTAL;
  out[3] = NTHREADS;
  out[4] = NB;
  out[5] = MAXACT;
  out[6] = BIG_TREE ? W_TOTAL : 0;   // device workspace floats per env
  out[7] = SM_TOTAL_F;                 // K1f's shared memory
  return 0;
}

#ifdef __CUDACC__
#define KERNEL_ARGS                                                         \
  const float* __restrict__ P, const int* __restrict__ seq_idx,            \
      const int* __restrict__ I,                                            \
      const float* __restrict__ qpos_in, const float* __restrict__ qvel_in, \
      const float* __restrict__ act_in, const float* __restrict__ tb_in,    \
      float* __restrict__ qpos_out, float* __restrict__ qvel_out,           \
      float* __restrict__ W, int act_dim, float rfc_rate

// the env's matrix workspace: shared memory, or its slice of W
#if BIG_TREE
#define ENV_WS (W + (size_t)blockIdx.x * W_TOTAL)
#else
#define ENV_WS sm
#endif

__global__ void __launch_bounds__(NTHREADS, 1)
control_step_kernel(KERNEL_ARGS) {
  extern __shared__ float sm[];
  control_step_env<false>(blockIdx.x, threadIdx.x, blockDim.x, sm, ENV_WS,
                          P, seq_idx, I, qpos_in, qvel_in, act_in, tb_in,
                          qpos_out, qvel_out, act_dim, rfc_rate, PART_FULL,
                          nullptr, nullptr, nullptr);
}

__global__ void __launch_bounds__(NTHREADS, 1)
control_step_f_kernel(KERNEL_ARGS, const float* __restrict__ vfx,
                      const float* __restrict__ ksc) {
  extern __shared__ float sm[];
  control_step_env<true>(blockIdx.x, threadIdx.x, blockDim.x, sm, ENV_WS,
                         P, seq_idx, I, qpos_in, qvel_in, act_in, tb_in,
                         qpos_out, qvel_out, act_dim, rfc_rate, PART_FULL,
                         nullptr, vfx, ksc);
}

__global__ void __launch_bounds__(NTHREADS, 1)
control_step_head_kernel(KERNEL_ARGS, float* __restrict__ X) {
  extern __shared__ float sm[];
  control_step_env<false>(blockIdx.x, threadIdx.x, blockDim.x, sm, ENV_WS,
                          P, seq_idx, I, qpos_in, qvel_in, act_in, tb_in,
                          qpos_out, qvel_out, act_dim, rfc_rate, PART_HEAD,
                          X, nullptr, nullptr);
}

__global__ void __launch_bounds__(NTHREADS, 1)
control_step_tail_kernel(KERNEL_ARGS, float* __restrict__ X) {
  extern __shared__ float sm[];
  control_step_env<false>(blockIdx.x, threadIdx.x, blockDim.x, sm, ENV_WS,
                          P, seq_idx, I, qpos_in, qvel_in, act_in, tb_in,
                          qpos_out, qvel_out, act_dim, rfc_rate, PART_TAIL,
                          X, nullptr, nullptr);
}

template <typename Kernel, typename... Args>
static int launch(Kernel kernel, int B, void* stream, const float* W,
                  int smem_floats, Args... args) {
  if (BIG_TREE && W == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = smem_floats * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, NTHREADS, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// Each launches on `stream` and returns the CUDA error code of the launch
// (0 = ok). P is the (S, P_TOTAL) model library, seq_idx (B,) int32 rows
// of it or null (row 0 for every env). W is the matrix workspace, B ×
// W_TOTAL float32 on a big tree (null at 24 bodies). X is (B, 2, NV, NV)
// float32: written by the head, read by the tail.
extern "C" int uhc_control_step(const float* P, const int* seq_idx,
                                const int* I, const float* qpos,
                                const float* qvel, const float* act,
                                const float* tb, float* qpos_out,
                                float* qvel_out, float* W, int B,
                                int act_dim, float rfc_rate, void* stream) {
  return launch(control_step_kernel, B, stream, W, SM_TOTAL, P, seq_idx, I,
                qpos, qvel, act, tb, qpos_out, qvel_out, W, act_dim,
                rfc_rate);
}

// K1f: K1 with the explicit wrench vfx (B, 9·NB) or null and the per-dof
// gain scales ksc (B, 2, NV) or null; W as for K1.
extern "C" int uhc_control_step_f(const float* P, const int* seq_idx,
                                  const int* I, const float* qpos,
                                  const float* qvel, const float* act,
                                  const float* tb, float* qpos_out,
                                  float* qvel_out, float* W,
                                  const float* vfx, const float* ksc, int B,
                                  int act_dim, float rfc_rate, void* stream) {
  return launch(control_step_f_kernel, B, stream, W, SM_TOTAL_F, P, seq_idx,
                I, qpos, qvel, act, tb, qpos_out, qvel_out, W, act_dim,
                rfc_rate, vfx, ksc);
}

extern "C" int uhc_control_step_head(const float* P, const int* seq_idx,
                                     const int* I, const float* qpos,
                                     const float* qvel, const float* act,
                                     const float* tb, float* qpos_out,
                                     float* qvel_out, float* W, float* X,
                                     int B, int act_dim, float rfc_rate,
                                     void* stream) {
  return launch(control_step_head_kernel, B, stream, W, SM_TOTAL, P,
                seq_idx, I, qpos, qvel, act, tb, qpos_out, qvel_out, W,
                act_dim, rfc_rate, X);
}

extern "C" int uhc_control_step_tail(const float* P, const int* seq_idx,
                                     const int* I, const float* qpos,
                                     const float* qvel, const float* act,
                                     const float* tb, float* qpos_out,
                                     float* qvel_out, float* W, float* X,
                                     int B, int act_dim, float rfc_rate,
                                     void* stream) {
  return launch(control_step_tail_kernel, B, stream, W, SM_TOTAL, P,
                seq_idx, I, qpos, qvel, act, tb, qpos_out, qvel_out, W,
                act_dim, rfc_rate, X);
}
#else
// Host build: every env on one thread, in order, with one workspace that
// each env reuses (shared memory itself at 24 bodies).
template <bool EXT>
static int run_host(const float* P, const int* seq_idx, const int* I,
                    const float* qpos, const float* qvel, const float* act,
                    const float* tb, float* qpos_out, float* qvel_out, int B,
                    int act_dim, float rfc_rate, int part, float* X,
                    const float* vfx, const float* ksc) {
  std::vector<float> sm(EXT ? SM_TOTAL_F : SM_TOTAL);
  std::vector<float> wbuf(BIG_TREE ? W_TOTAL : 0);
  float* ws = BIG_TREE ? wbuf.data() : sm.data();
  for (int env = 0; env < B; ++env)
    control_step_env<EXT>(env, 0, 1, sm.data(), ws, P, seq_idx, I, qpos,
                          qvel, act, tb, qpos_out, qvel_out, act_dim,
                          rfc_rate, part, X, vfx, ksc);
  return 0;
}

extern "C" int uhc_control_step_host(const float* P, const int* seq_idx,
                                     const int* I, const float* qpos,
                                     const float* qvel, const float* act,
                                     const float* tb, float* qpos_out,
                                     float* qvel_out, int B, int act_dim,
                                     float rfc_rate) {
  return run_host<false>(P, seq_idx, I, qpos, qvel, act, tb, qpos_out,
                         qvel_out, B, act_dim, rfc_rate, PART_FULL, nullptr,
                         nullptr, nullptr);
}

extern "C" int uhc_control_step_f_host(
    const float* P, const int* seq_idx, const int* I, const float* qpos,
    const float* qvel, const float* act, const float* tb, float* qpos_out,
    float* qvel_out, const float* vfx, const float* ksc, int B, int act_dim,
    float rfc_rate) {
  return run_host<true>(P, seq_idx, I, qpos, qvel, act, tb, qpos_out,
                        qvel_out, B, act_dim, rfc_rate, PART_FULL, nullptr,
                        vfx, ksc);
}

extern "C" int uhc_control_step_head_host(
    const float* P, const int* seq_idx, const int* I, const float* qpos,
    const float* qvel, const float* act, const float* tb, float* qpos_out,
    float* qvel_out, float* X, int B, int act_dim, float rfc_rate) {
  return run_host<false>(P, seq_idx, I, qpos, qvel, act, tb, qpos_out,
                         qvel_out, B, act_dim, rfc_rate, PART_HEAD, X,
                         nullptr, nullptr);
}

extern "C" int uhc_control_step_tail_host(
    const float* P, const int* seq_idx, const int* I, const float* qpos,
    const float* qvel, const float* act, const float* tb, float* qpos_out,
    float* qvel_out, float* X, int B, int act_dim, float rfc_rate) {
  return run_host<false>(P, seq_idx, I, qpos, qvel, act, tb, qpos_out,
                         qvel_out, B, act_dim, rfc_rate, PART_TAIL, X,
                         nullptr, nullptr);
}
#endif
