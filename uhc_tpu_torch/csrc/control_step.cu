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
//    (0.69 / 0.80 MB) exceed a block's 227 KB of shared memory. A_pd,
//    A_fd, J6 and G live in a per-env workspace in device memory (`ws`,
//    W_TOTAL floats per env, allocated by the caller), and a thread reads
//    a column of A_pd, A_fd so that a warp's loads are coalesced. The two
//    preconditioners Xp, Xf stay in shared memory as packed lower
//    triangles (87 / 102 KB), as on every tree.
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
//  * K2b, the bfloat16 preconditioner of pallas_substep.py
//    make_fused_do_simulation (precond_bf16=True, :245-254, :884-887,
//    :1033): `control_step_bf16_kernel` (split=False) and
//    `control_step_head_bf16_kernel` + `_tail_bf16_kernel` (split=True),
//    the template's BF16 instance. Every entry of Xp and Xf is rounded to
//    the nearest bfloat16 as the exact inverses are written; each
//    preconditioner product X v (the PCG warm start and every z = X r)
//    rounds v to bfloat16 first, so its products are exact in float32 and
//    accumulate in float32; A, the residuals and the PCG scalars stay
//    float32. Head and tail hand Xp, Xf over as (B, 2, NV, NV) bfloat16,
//    half of K2's round trip. One rounding function by bit arithmetic
//    (`bf16_bits`, torch's round-to-nearest-even) serves the CUDA and the
//    host build. With BF16 false every kernel compiles as before.
//
// The plain PyTorch version is uhc_tpu_torch/physics/solver.py
// do_simulation (K1) and its head/tail pieces `substeps` (K2) with the
// same (pd_iters, fd_iters) schedule.
//
// What bounds it on the H100: float32 arithmetic outside the tensor cores
// (67 TFLOP/s). Per env and substep the algorithm assembles M = GᵀG and
// CD = J6ᵀ·W·J6 from the (6·NB × NV) Jacobians, and substep 0 adds two
// NV × NV Cholesky inverses; the state it reads and writes is under 2 KB
// per env, so bytes never bound it.
//
// What the design does about it:
//  * every tree keeps Xp and Xf in shared memory as packed lower triangles
//    and computes the exact inverse pair there in place, in panels
//    (`exact_inverses`); the head/tail split writes them out in full and
//    reads them back into the triangles;
//  * at 24 bodies everything of one env stays in shared memory for all 15
//    substeps: Xp, Xf (22.8 KB), A_pd, A_fd in full (45.0 KB), the state
//    (19.4 KB) and J6, G stored by subtree (body b's 6 rows hold only the
//    6 + 3·depth(b) dofs of its ancestors: 20.6 KB on the SMPL tree), 107.8
//    KB a block (K1f 109.2), so two blocks share an SM and nothing but the
//    state touches device memory; a tree of another depth asks for its own
//    J6 / G size at launch. On a big tree A_pd, A_fd, J6 and G go through
//    L1/L2 to the workspace in full rows;
//  * the Jacobian columns of a dof are zero outside the subtree of the
//    dof's body, and bodies are in depth-first order, so every entry of M,
//    CD and Jᵀ·wrench sums over a contiguous range of bodies only (a few
//    percent of the dense work for a limb), J6, G and K = W·J6 are built
//    for the (body, ancestor dof) pairs only, and CD skips bodies without
//    an active ground contact;
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
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
#define SYNC() __syncthreads()
#define SYNCWARP() __syncwarp()
#else
#include <vector>
#define HD static inline
#define SYNC() ((void)0)
#define SYNCWARP() ((void)0)
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
#define NTRI (NV * (NV + 1) / 2)
// K1d: trees of more than 32 bodies keep their matrices in a per-env
// workspace in device memory (see the workspace layout below).
#define BIG_TREE (NB > 32)
// Threads per block (one block per env): 512 on every tree. The resident
// blocks per SM the launch bounds ask for (MINBLOCKS) follow from the
// build's shared memory, below the shared-memory layout.
#define NTHREADS 512
// the blocked exact inverse's panel width; a panel's columns (Cholesky,
// L⁻¹) or rows (Yᵀ Y) go to the panel (2·NV rows), PB floats in each row
// of PS: a lane's two 16-byte loads of a row then meet no other lane's
// banks
#define PB 8
#define PS 12
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
// J6 and G by subtree (24 bodies): body b's 6 rows hold the dofs of its
// ancestors (b included), 6 + 3·depth(b) columns in dof order, so a dof
// has one column in the rows of every body below it. The (body, dof)
// pairs with the dof above the body are what phases E and H build, on
// every tree. JP_MAX: the pairs of a chain, the most a tree has.
#define JP_MAX (6 * NB + 3 * NB * (NB - 1) / 2)
enum {
  I_PARENT = 0,                    // NB
  I_SUBEND = I_PARENT + NB,        // NB: subtree of b = bodies [b, end)
  I_LEVBODY = I_SUBEND + NB,       // NB: non-root bodies by depth
  I_LEVSTART = I_LEVBODY + NB,     // NB+1: level offsets into LEVBODY
  I_NLEV = I_LEVSTART + NB + 1,
  I_NPAIR = I_NLEV + 1,
  I_PAIRS = I_NPAIR + 1,           // MAXPAIR*2
  I_JROW = I_PAIRS + MAXPAIR * 2,  // 6*NB+1: offset of row 6b+k; then the
                                   // floats of each of J6, G
  I_JCOL = I_JROW + 6 * NB + 1,    // NV: the column of dof j
  I_NJP = I_JCOL + NV,             // pairs
  I_JPAIR = I_NJP + 1,             // JP_MAX: b * NV + j, by body, column
  I_SELFCOL = I_JPAIR + JP_MAX,
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
// A_pd and A_fd in full (both triangles equal bit for bit), J6 and G. On
// a big tree they exceed a block's 227 KB: they live in device memory,
// W_TOTAL floats per env (0.51 MB at 48 bodies, 0.60 MB at 52, 0.67 MB at
// 55), J6 and G in full NV-wide rows. At 24 bodies A_pd and A_fd follow Xp
// and Xf in shared memory (the workspace is shared memory itself), and J6
// and G come last, by subtree (SM_JG).
#if BIG_TREE
enum {
  W_APD = 0,
  W_AFD = W_APD + NV * NV,
  W_J6 = W_AFD + NV * NV,            // (NB*6) × NV
  W_G = W_J6 + NB * 6 * NV,          // G, then K = W·J6
  W_TOTAL = W_G + NB * 6 * NV
};
#else
enum {
  W_APD = (2 * NTRI + 3) / 4 * 4,
  W_AFD = W_APD + NV * NV,
  W_TOTAL = W_AFD + NV * NV
};
#endif

// ---- shared memory layout (floats) ----------------------------------------
// Xp and Xf packed (SM_PX, 2 × NTRI floats: 22.8 KB at 24 bodies, 87.0 KB
// at 48, 101.8 KB at 52, 113.6 KB at 55); on a big tree the inverse's
// panel (SM_PANEL, 14.1 to 16.1 KB), at 24 bodies A_pd and A_fd; the state,
// the per-body vectors and the PCG vectors; K1f's two operands; at 24
// bodies J6 and G by subtree (SM_JG, I_JROW[6·NB] floats each), on which
// the inverse's panel lies: nothing reads J6 or G from phase I to the next
// substep's phase E, which rebuilds them.
enum {
  SM_PX = 0,                         // Xp, Xf packed (2 × NTRI)
  SM_PANEL = (2 * NTRI + 3) / 4 * 4, // big tree: 2*NV × PS, 16-byte aligned
  SM_QPOS = BIG_TREE ? SM_PANEL + 2 * NV * PS : W_TOTAL,
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
  SM_TOTAL_F = SM_KSC + 2 * NV,
  // 24 bodies: J6 then G (the panel's floats at least), 16-byte aligned
  SM_JG = (SM_TOTAL + 3) / 4 * 4,
  SM_JG_F = (SM_TOTAL_F + 3) / 4 * 4
};

// The fewest floats of each of J6, G by subtree: every body at depth 1.
// The inverse's panel (2·NV·PS floats) fits on them.
#define JG_MIN (6 * (6 * NB + 3 * (NB - 1)))
static_assert(BIG_TREE || JG_MIN >= NV * PS, "the panel fits on J6, G");

// An SM's shared memory and a block's most (H100: 228 KB and 227 KB, 1 KB
// of each block's reserved by the system).
#define SM_SMEM_BYTES (228 * 1024)
#define BLOCK_SMEM_BYTES (227 * 1024)
// A small tree's block holds every matrix of its env: K1f's floats with J6
// and G at their most (a chain of NB bodies, 6·JP_MAX floats each) must
// fit a block; at 32 bodies that is 220.1 KB.
static_assert(BIG_TREE || 4 * (SM_JG_F + 12 * JP_MAX) <= BLOCK_SMEM_BYTES,
              "a small tree's block fits its shared memory");
// Resident blocks per SM: two where two blocks of K1f with J6 and G at
// their fewest fit an SM (84.1 KB at 22 bodies, 96.6 KB at 24; up to 26
// bodies), so ptxas fits a thread in 64 registers for 64 warps an SM (in
// turns on an H100 that ran K1 at 24 bodies faster than 256 threads at
// 107 registers or 384, PERF.md); one on a small tree too large for two
// (154.8 KB at 32 bodies) and on a big tree (137 to 174 KB, 16 warps to
// hide the workspace's latency, 128 registers).
#define TWO_BLOCKS_BYTES (2 * (4 * (SM_JG_F + 2 * JG_MIN) + 1024))
#define MINBLOCKS ((BIG_TREE || TWO_BLOCKS_BYTES > SM_SMEM_BYTES) ? 1 : 2)

// Floats of a block's shared memory: K1f's (ext) or another kernel's, with
// `jg` floats in each of J6 and G at 24 bodies (the int table's
// I_JROW[6·NB]); a big tree's do not depend on it.
static inline int smem_floats(bool ext, int jg) {
#if BIG_TREE
  return ext ? SM_TOTAL_F : SM_TOTAL;
#else
  return (ext ? SM_JG_F : SM_JG) + 2 * jg;
#endif
}

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

// float <-> its bits, the same on the card and on the host
#ifdef __CUDACC__
HD uint32_t float_bits(float x) { return __float_as_uint(x); }
HD float bits_float(uint32_t u) { return __uint_as_float(u); }
#else
HD uint32_t float_bits(float x) {
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  return u;
}
HD float bits_float(uint32_t u) {
  float x;
  memcpy(&x, &u, sizeof x);
  return x;
}
#endif

// K2b: the bfloat16 nearest to x, ties to even (NaN -> 0x7FC0), as its 16
// bits: c10::BFloat16's rounding, so it agrees with torch's .to(bfloat16)
HD uint16_t bf16_bits(float x) {
  uint32_t u = float_bits(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)0x7fc0u;
  return (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

HD float bf16_float(uint16_t h) { return bits_float((uint32_t)h << 16); }

HD float round_bf16(float x) { return bf16_float(bf16_bits(x)); }

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

// Offset of entry (i, k) of A_pd or A_fd, stored in full: every writer
// stores both triangles equal bit for bit. At 24 bodies A lies in shared
// memory and the thread of row i reads along its row (a warp's 32 rows at
// one k lie NV = 75 floats apart, 32 distinct banks). On a big tree A
// lies in device memory, and the thread of row i reads column i instead
// (k·NV + i), so at each k a warp's load is one or two 128-byte lines;
// each row's sum keeps its k order, so the result is the same bit for bit.
HD int sym_at(int i, int k) { return BIG_TREE ? k * NV + i : i * NV + k; }

// Offset of row r = 6b + k of J6 or G, and the column of dof j in it: by
// subtree from the int table at 24 bodies; full NV-wide rows in a big
// tree's workspace.
HD int jg_row(const int* I, int r) {
  return BIG_TREE ? r * NV : I[I_JROW + r];
}
HD int jg_col(const int* I, int j) { return BIG_TREE ? j : I[I_JCOL + j]; }

// y = A x over the rows owned by this thread
HD void matvec(const float* A, const float* x, float* y, int tid, int nth) {
  for (int i = tid; i < NV; i += nth) {
    float s = 0.0f;
    for (int k = 0; k < NV; ++k) s += A[sym_at(i, k)] * x[k];
    y[i] = s;
  }
}

// first entry of row i of a packed lower triangle
HD int tri_row(int i) { return i * (i + 1) / 2; }

// y = X v for X stored as its packed lower triangle (Xp, Xf in shared
// memory): entry (i, k) at tri_row(i) + k for k ≤ i, at
// tri_row(k) + i for k > i. Each row sums in ascending k, as `matvec` over
// the full matrix does. Within a warp the row part reads are a permutation
// of the banks (triangular numbers mod 32), the column part contiguous.
HD void matvec_packed(const float* X, const float* x, float* y, int tid,
                      int nth) {
  for (int i = tid; i < NV; i += nth) {
    const int ti = tri_row(i);
    float s = 0.0f;
    int tk = 0;
    for (int k = 0; k < NV; ++k) {
      s += X[k <= i ? ti + k : tk + i] * x[k];
      tk += k + 1;
    }
    y[i] = s;
  }
}

HD float dot75(const float* a, const float* b) {
  float s = 0.0f;
  for (int k = 0; k < NV; ++k) s += a[k] * b[k];
  return s;
}

// y = X v, the preconditioner product over the packed triangle X. BF16
// (K2b): X holds bfloat16 values and v is rounded to bfloat16 into `vr`
// first, so every product is exact in float32 and the sum accumulates in
// float32.
template <bool BF16>
HD void precond(const float* X, const float* v, float* y, float* vr,
                int tid, int nth) {
  if (BF16) {
    for (int i = tid; i < NV; i += nth) vr[i] = round_bf16(v[i]);
    SYNC();
    v = vr;
  }
  matvec_packed(X, v, y, tid, nth);
}

// PCG with warm start x0 = X b (X ≈ A⁻¹): the solution lands in SM_X. The
// bfloat16 copies of b and r (BF16) go through SM_AP, which holds nothing
// live at those points.
template <bool BF16>
HD void pcg(float* sm, const float* A, const float* X, const float* b,
            int iters, int tid, int nth) {
  float* x = sm + SM_X;
  float* r = sm + SM_R;
  float* z = sm + SM_Z;
  float* p = sm + SM_P;
  float* Ap = sm + SM_AP;
  float* scal = sm + SM_SCAL;
  precond<BF16>(X, b, x, Ap, tid, nth);
  SYNC();
  for (int i = tid; i < NV; i += nth) {
    float s = 0.0f;
    for (int k = 0; k < NV; ++k) s += A[sym_at(i, k)] * x[k];
    r[i] = b[i] - s;
  }
  SYNC();
  precond<BF16>(X, r, z, Ap, tid, nth);
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
    precond<BF16>(X, r, z, Ap, tid, nth);
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

// the PB floats of one panel row at p (16-byte aligned)
HD void load_panel(const float* p, float* v) {
#ifdef __CUDACC__
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
#else
  for (int kk = 0; kk < PB; ++kk) v[kk] = p[kk];
#endif
}

// Exact inverses of A_pd -> Xp and A_fd -> Xf (substep 0, and I_REFRESH)
// in place on the packed lower triangles in shared memory (SM_PX), the two
// matrices in lockstep: the lower triangles of A_pd, A_fd come in from the
// workspace, then the Cholesky factor L, Y = L⁻¹ and X = Yᵀ Y. Every entry
// receives the operations of the unblocked algorithm (right-looking
// Cholesky, a forward substitution per column of Y, then X_ij = Σ_k Y_ki
// Y_kj in ascending k), in the same order, so the result is the same bit
// for bit; what differs is how the steps are grouped, in panels of PB
// columns or rows, through the panel `pan` (2·NV rows of PS floats):
//  * Cholesky: step k scales column k by d_k = sqrt(max(A_kk, 1e-12)) and
//    subtracts L_ik L_jk from every k < j <= i. Within a panel the steps
//    run one by one on the panel's columns; then every entry right of the
//    panel takes the panel's PB terms at once, in k order, from the
//    panel's columns (one barrier for PB steps).
//  * Y = L⁻¹ column-parallel: step k finishes row k of Y (Y_kc = s_kc /
//    d_k, s = 1 on the diagonal) and subtracts L_ik Y_kc from the sum
//    s_ic of every row i > k, c <= k, which sits where L_ic was read for
//    the last time. Within a panel of rows the steps run one by one on the
//    panel's rows; then every row below takes the panel's PB terms at
//    once from the panel's rows of Y in the panel.
//  * X_ij = Σ_{k>=i} Y_ki Y_kj: a panel's rows of Y go to the panel, then
//    every entry of the rows above adds their terms in k order; the sums
//    of the panel's own rows start where those rows of Y were.
// The big updates run a row per warp, lanes along the row (contiguous in
// the packed layout), PB operands of a lane in two 16-byte loads and its
// sum in a register. Under BF16 (K2b) every entry is rounded to bfloat16
// at the end.
template <bool BF16>
HD void exact_inverses(float* sm, const float* ws, float* pan, int tid,
                       int nth) {
  float* T = sm + SM_PX;             // Xp then Xf, NTRI floats each
  float* diag = sm + SM_DIAG;        // 2*NV Cholesky diagonals
  const int nl = nth < 32 ? nth : 32, lane = tid % nl, warp = tid / nl;
  const int nw = nth / nl;
  for (int t = tid; t < 2 * NV * NV; t += nth) {
    int m = t / (NV * NV), e = t - m * NV * NV, i = e / NV, j = e - i * NV;
    if (j <= i) T[m * NTRI + tri_row(i) + j] = ws[(m ? W_AFD : W_APD) + e];
  }
  SYNC();
  // -- Cholesky --
  for (int k0 = 0; k0 < NV; k0 += PB) {
    const int k1 = k0 + PB < NV ? k0 + PB : NV;
    for (int k = k0; k < k1; ++k) {
      for (int t = tid; t < 2 * (NV - k); t += nth) {   // column k
        int m = t & 1, i = k + (t >> 1);
        float* A = T + m * NTRI;
        float d = sqrtf(fmaxf(A[tri_row(k) + k], 1e-12f));
        if (i == k) {
          diag[m * NV + k] = d;
        } else {
          float v = A[tri_row(i) + k] / d;
          A[tri_row(i) + k] = v;
          if (i >= k1) pan[(m * NV + i) * PS + k - k0] = v;
        }
      }
      SYNC();
      if (k + 1 == k1) break;
      for (int t = tid; t < 2 * (NV - k - 1) * PB; t += nth) {
        // the panel's columns k < j < k1 with column k
        int j = k + 1 + (t & (PB - 1)), r = t / PB, m = r & 1;
        int i = k + 1 + (r >> 1);
        if (j >= k1 || j > i) continue;
        float* A = T + m * NTRI;
        A[tri_row(i) + j] -= A[tri_row(i) + k] * A[tri_row(j) + k];
      }
      SYNC();
    }
    if (k1 == NV) break;
    for (int r = warp; r < 2 * (NV - k1); r += nw) {  // right of the panel
      int m = r & 1, i = k1 + (r >> 1);
      float* row = T + m * NTRI + tri_row(i);
      float li[PB], lj[PB];
      load_panel(pan + (m * NV + i) * PS, li);
      for (int j = k1 + lane; j <= i; j += nl) {
        load_panel(pan + (m * NV + j) * PS, lj);
        float a = row[j];
        for (int kk = 0; kk < PB; ++kk) a -= li[kk] * lj[kk];
        row[j] = a;
      }
    }
    SYNC();
  }
  // -- Y = L⁻¹ --
  for (int k0 = 0; k0 < NV; k0 += PB) {
    const int k1 = k0 + PB < NV ? k0 + PB : NV;
    for (int k = k0; k < k1; ++k) {
      for (int t = tid; t < 2 * (k + 1); t += nth) {    // row k of Y
        int m = t & 1, c = t >> 1;
        float* row = T + m * NTRI + tri_row(k);
        float y = (c == k ? 1.0f : row[c]) / diag[m * NV + k];
        row[c] = y;
        pan[(m * NV + c) * PS + k - k0] = y;
      }
      SYNC();
      if (k + 1 == k1) break;
      for (int r = warp; r < 2 * (k1 - k - 1); r += nw) {
        // the panel's rows k < i < k1 with row k
        int m = r & 1, i = k + 1 + (r >> 1);
        float* row = T + m * NTRI + tri_row(i);
        const float* yk = T + m * NTRI + tri_row(k);
        float li = row[k];
        SYNCWARP();
        for (int c = lane; c <= k; c += nl) {
          if (c < k) {
            row[c] -= li * yk[c];
          } else {
            float s = 0.0f;
            s -= li * yk[k];
            row[k] = s;
          }
        }
      }
      SYNC();
    }
    if (k1 == NV) break;
    for (int r = warp; r < 2 * (NV - k1); r += nw) {    // rows below
      int m = r & 1, i = k1 + (r >> 1);
      float* row = T + m * NTRI + tri_row(i);
      float li[PB], yc[PB];
      for (int kk = 0; kk < PB; ++kk) li[kk] = row[k0 + kk];
      SYNCWARP();
      for (int c = lane; c < k1; c += nl) {
        load_panel(pan + (m * NV + c) * PS, yc);
        const int cc = c - k0;       // the first term's k - k0 (< 0: all)
        float s = c < k0 ? row[c] : 0.0f;
        for (int kk = 0; kk < PB; ++kk)
          if (kk >= cc) s -= li[kk] * yc[kk];
        row[c] = s;
      }
    }
    SYNC();
  }
  // -- X = Yᵀ Y --
  for (int k0 = 0; k0 < NV; k0 += PB) {
    const int k1 = k0 + PB < NV ? k0 + PB : NV, w = k1 - k0;
    for (int t = tid; t < 2 * k1 * PB; t += nth) {      // rows k0..k1-1
      int kk = t & (PB - 1), r = t / PB, m = r & 1, j = r >> 1;
      pan[(m * NV + j) * PS + kk] =
          kk < w && j <= k0 + kk ? T[m * NTRI + tri_row(k0 + kk) + j] : 0.0f;
    }
    SYNC();
    for (int r = warp; r < 2 * k1; r += nw) {           // rows i < k1
      int m = r & 1, i = r >> 1;
      float* row = T + m * NTRI + tri_row(i);
      float yi[PB], yj[PB];
      load_panel(pan + (m * NV + i) * PS, yi);
      const int ii = i - k0;         // the first term's k - k0 (< 0: all)
      for (int j = lane; j <= i; j += nl) {
        load_panel(pan + (m * NV + j) * PS, yj);
        float a = i < k0 ? row[j] : 0.0f;
        for (int kk = 0; kk < PB; ++kk)
          if (kk >= ii && kk < w) a += yi[kk] * yj[kk];
        row[j] = a;
      }
    }
    SYNC();
  }
  if (BF16) {
    for (int t = tid; t < 2 * NTRI; t += nth) T[t] = round_bf16(T[t]);
    SYNC();
  }
}

// Which substeps a launch runs: all (K1), substep 0 (K2 head) or
// substeps 1.. (K2 tail).
enum { PART_FULL = 0, PART_HEAD = 1, PART_TAIL = 2 };

// Substeps of one env. The head stores Xp, Xf to X (env-major, Xp then
// Xf); the tail loads them from X: float32, or the 16 bits of each
// bfloat16 under BF16 (K2b). The env's model is row seq_idx[env] of the
// library Plib (row 0 without seq_idx). `ws` is the env's matrix
// workspace: `sm` itself at 24 bodies (A_pd, A_fd; J6 and G at SM_JG or
// SM_JG_F), its slice of device memory on a big tree. EXT (K1f) reads the explicit wrench `vfx_in` (B, 9·NB) and
// the per-dof gain scales `ksc_in` (B, 2, NV) where the int table asks
// for them; without EXT both are null and unread.
template <bool EXT, bool BF16>
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
#if BIG_TREE
  float* J6 = ws + W_J6;
  float* G = ws + W_G;
  float* pan = sm + SM_PANEL;        // the inverse's panel
#else
  float* J6 = sm + (EXT ? SM_JG_F : SM_JG);
  float* G = J6 + I[I_JROW + 6 * NB];
  float* pan = J6;
#endif

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
  float* Xs = sm + SM_PX;            // Xp then Xf, NTRI floats each
  if (part == PART_TAIL)
    for (int t = tid; t < 2 * NV * NV; t += nth) {
      int m = t / (NV * NV), e = t - m * NV * NV, i = e / NV, j = e - i * NV;
      if (j > i) continue;
      Xs[m * NTRI + tri_row(i) + j] = BF16 ? bf16_float(reinterpret_cast<const uint16_t*>(
                        X)[(size_t)env * 2 * NV * NV + t])
                  : X[(size_t)env * 2 * NV * NV + t];
    }
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
    // (J6 and G at the (body, dof) pairs only: nothing reads the rest)
    const int npair = I[I_NPAIR];
    const int njp = I[I_NJP];
    for (int t = tid; t < 2 * NB + npair + 6 * njp; t += nth) {
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
        // row k of body b at dof j, j above b
        int e = t - 2 * NB - npair;
        int k = e / njp, bjp = I[I_JPAIR + e - k * njp];
        int b = bjp / NV, j = bjp - b * NV;
        int bj = dof_body(j);
        float jv = 0.f, gv = 0.f;
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
        const int o = jg_row(I, 6 * b + k) + jg_col(I, j);
        J6[o] = jv;
        G[o] = gv;
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
        int j = t, bj = dof_body(j), cj = jg_col(I, j);
        float c = 0.f, fx = 0.f;
        for (int row = 6 * bj; row < 6 * I[I_SUBEND + bj]; ++row) {
          float jv = J6[jg_row(I, row) + cj];
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
        const int ci = jg_col(I, i), cj = jg_col(I, j);
        float m = 0.f;
        if (d >= 0)
          for (int row = 6 * d; row < 6 * I[I_SUBEND + d]; ++row) {
            const int o = jg_row(I, row);
            m += G[o + ci] * G[o + cj];
          }
        if (i == j) m += P[P_ARMATURE + i];
        float apd = (i == j) ? m + sm[SM_KDF + i] * dt : m;
        ws[W_APD + i * NV + j] = apd;
        ws[W_APD + j * NV + i] = apd;
        ws[W_AFD + i * NV + j] = m;
        ws[W_AFD + j * NV + i] = m;
      }
    }
    SYNC();

    // -- H: K = W·J6 for bodies in contact (into G), at the pairs -------
    for (int t = tid; t < 6 * njp; t += nth) {
      int c = t / njp, bjp = I[I_JPAIR + t - c * njp];
      int b = bjp / NV, cj = jg_col(I, bjp - b * NV);
      if (!(sm[SM_ACTIVE + b] > 0.f)) continue;
      const float* W = sm + SM_W + 36 * b + 6 * c;
      float s2 = 0.f;
      for (int k = 0; k < 6; ++k) s2 += W[k] * J6[jg_row(I, 6 * b + k) + cj];
      G[jg_row(I, 6 * b + c) + cj] = s2;
    }
    SYNC();

    // -- I: A_fd = M + dt·(CD + diag(limit damping)) ---------------------
    for (int t = tid; t < NTRI; t += nth) {
      int i, j;
      tri_index(t, &i, &j);
      int d = related(dof_body(i), dof_body(j), I);
      const int ci = jg_col(I, i), cj = jg_col(I, j);
      float cd = 0.f;
      if (d >= 0)
        for (int b = d; b < I[I_SUBEND + d]; ++b) {
          if (!(sm[SM_ACTIVE + b] > 0.f)) continue;
          for (int k = 0; k < 6; ++k) {
            const int o = jg_row(I, 6 * b + k);
            cd += J6[o + ci] * G[o + cj];
          }
        }
      if (i == j) cd += sm[SM_LIMD + i];
      float v = ws[W_AFD + i * NV + j] + dt * cd;
      ws[W_AFD + i * NV + j] = v;
      ws[W_AFD + j * NV + i] = v;
    }
    SYNC();

    // at 24 bodies the inverses' panel overwrites J6 and G, which nothing
    // reads again before the next substep's phase E rebuilds them: so also
    // at I_REFRESH
    if (s == 0 || s == I[I_REFRESH])
      exact_inverses<BF16>(sm, ws, pan, tid, nth);

    // -- stable PD: q̈_des, torques, forward dynamics -------------------
    pcg<BF16>(sm, ws + W_APD, Xs, sm + SM_PDRHS, I[I_PD_ITERS], tid, nth);
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
    pcg<BF16>(sm, ws + W_AFD, Xs + NTRI, sm + SM_RHS, I[I_FD_ITERS], tid,
              nth);

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
    for (int t = tid; t < 2 * NV * NV; t += nth) {
      int m = t / (NV * NV), e = t - m * NV * NV, i = e / NV, j = e - i * NV;
      float v = Xs[m * NTRI + (j <= i ? tri_row(i) + j : tri_row(j) + i)];
      if (BF16)
        reinterpret_cast<uint16_t*>(X)[(size_t)env * 2 * NV * NV + t] =
            bf16_bits(v);
      else
        X[(size_t)env * 2 * NV * NV + t] = v;
    }
  for (int t = tid; t < NQ; t += nth) qpos_out[(size_t)env * NQ + t] = qpos[t];
  for (int t = tid; t < NV; t += nth) qvel_out[(size_t)env * NV + t] = qvel[t];
}

// ---- entry points (plain C interface for ctypes) --------------------------

// A block's shared memory, in floats, with `jg` floats in each of J6, G:
// K1's (and every other kernel's) -> out[0], K1f's -> out[1].
extern "C" int uhc_control_step_smem(int jg, int* out) {
  out[0] = smem_floats(false, jg);
  out[1] = smem_floats(true, jg);
  return 0;
}

extern "C" int uhc_control_step_layout(int* out) {
  out[0] = P_TOTAL;
  out[1] = I_TOTAL;
  out[2] = SM_TOTAL;                   // shared memory (at 24 bodies
  out[3] = NTHREADS;                   // before J6 and G: smem_floats)
  out[4] = NB;
  out[5] = MAXACT;
  out[6] = BIG_TREE ? W_TOTAL : 0;   // device workspace floats per env
  out[7] = SM_TOTAL_F;                 // K1f's, as out[2]
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

__global__ void __launch_bounds__(NTHREADS, MINBLOCKS)
control_step_kernel(KERNEL_ARGS) {
  extern __shared__ __align__(16) float sm[];
  control_step_env<false, false>(blockIdx.x, threadIdx.x, blockDim.x, sm, ENV_WS,
                          P, seq_idx, I, qpos_in, qvel_in, act_in, tb_in,
                          qpos_out, qvel_out, act_dim, rfc_rate, PART_FULL,
                          nullptr, nullptr, nullptr);
}

__global__ void __launch_bounds__(NTHREADS, MINBLOCKS)
control_step_f_kernel(KERNEL_ARGS, const float* __restrict__ vfx,
                      const float* __restrict__ ksc) {
  extern __shared__ __align__(16) float sm[];
  control_step_env<true, false>(blockIdx.x, threadIdx.x, blockDim.x, sm, ENV_WS,
                         P, seq_idx, I, qpos_in, qvel_in, act_in, tb_in,
                         qpos_out, qvel_out, act_dim, rfc_rate, PART_FULL,
                         nullptr, vfx, ksc);
}

__global__ void __launch_bounds__(NTHREADS, MINBLOCKS)
control_step_head_kernel(KERNEL_ARGS, float* __restrict__ X) {
  extern __shared__ __align__(16) float sm[];
  control_step_env<false, false>(blockIdx.x, threadIdx.x, blockDim.x, sm, ENV_WS,
                          P, seq_idx, I, qpos_in, qvel_in, act_in, tb_in,
                          qpos_out, qvel_out, act_dim, rfc_rate, PART_HEAD,
                          X, nullptr, nullptr);
}

__global__ void __launch_bounds__(NTHREADS, MINBLOCKS)
control_step_tail_kernel(KERNEL_ARGS, float* __restrict__ X) {
  extern __shared__ __align__(16) float sm[];
  control_step_env<false, false>(blockIdx.x, threadIdx.x, blockDim.x, sm, ENV_WS,
                          P, seq_idx, I, qpos_in, qvel_in, act_in, tb_in,
                          qpos_out, qvel_out, act_dim, rfc_rate, PART_TAIL,
                          X, nullptr, nullptr);
}

// K2b: K1 at a symmetric schedule (split=False), head and tail with the
// bfloat16 preconditioner; X is (B, 2, NV, NV) bfloat16
__global__ void __launch_bounds__(NTHREADS, MINBLOCKS)
control_step_bf16_kernel(KERNEL_ARGS) {
  extern __shared__ __align__(16) float sm[];
  control_step_env<false, true>(blockIdx.x, threadIdx.x, blockDim.x, sm,
                                ENV_WS, P, seq_idx, I, qpos_in, qvel_in,
                                act_in, tb_in, qpos_out, qvel_out, act_dim,
                                rfc_rate, PART_FULL, nullptr, nullptr,
                                nullptr);
}

__global__ void __launch_bounds__(NTHREADS, MINBLOCKS)
control_step_head_bf16_kernel(KERNEL_ARGS, float* __restrict__ X) {
  extern __shared__ __align__(16) float sm[];
  control_step_env<false, true>(blockIdx.x, threadIdx.x, blockDim.x, sm,
                                ENV_WS, P, seq_idx, I, qpos_in, qvel_in,
                                act_in, tb_in, qpos_out, qvel_out, act_dim,
                                rfc_rate, PART_HEAD, X, nullptr, nullptr);
}

__global__ void __launch_bounds__(NTHREADS, MINBLOCKS)
control_step_tail_bf16_kernel(KERNEL_ARGS, float* __restrict__ X) {
  extern __shared__ __align__(16) float sm[];
  control_step_env<false, true>(blockIdx.x, threadIdx.x, blockDim.x, sm,
                                ENV_WS, P, seq_idx, I, qpos_in, qvel_in,
                                act_in, tb_in, qpos_out, qvel_out, act_dim,
                                rfc_rate, PART_TAIL, X, nullptr, nullptr);
}

// Shared memory and resident blocks: the block's floats (smem_floats),
// and the carveout that gives shared memory all it can, so that two
// 24-body blocks fit an SM.
template <typename Kernel>
static cudaError_t set_smem(Kernel kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}

// `jg`: the floats of each of J6, G by subtree (24 bodies); a big tree
// needs its workspace W instead.
template <typename Kernel, typename... Args>
static int launch(Kernel kernel, bool ext, int B, void* stream,
                  const float* W, int jg, Args... args) {
  if (BIG_TREE ? W == nullptr : jg < JG_MIN)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_floats(ext, jg) * (int)sizeof(float);
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B, NTHREADS, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// What the card makes of one kernel: registers a thread, local memory
// bytes a thread (stack frame and spills), dynamic shared bytes, threads
// and resident blocks per SM at that shared memory -> out[0..4].
template <typename Kernel>
static int occupancy(Kernel kernel, int smem_floats, int* out) {
  const int smem = smem_floats * (int)sizeof(float);
  cudaFuncAttributes a;
  cudaError_t e = set_smem(kernel, smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      NTHREADS, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = smem;
  out[3] = NTHREADS;
  out[4] = blocks;
  return 0;
}

// occupancy() of every entry, 5 ints each, in the order K1 (K1e, K1d),
// K1f, K2 head, K2 tail, K2b at split=False, K2b head, K2b tail, with
// `jg` floats in each of J6, G (24 bodies).
extern "C" int uhc_control_step_occupancy(int jg, int* out) {
  const int sm = smem_floats(false, jg), smf = smem_floats(true, jg);
  int e = 0;
  if (!e) e = occupancy(control_step_kernel, sm, out);
  if (!e) e = occupancy(control_step_f_kernel, smf, out + 5);
  if (!e) e = occupancy(control_step_head_kernel, sm, out + 10);
  if (!e) e = occupancy(control_step_tail_kernel, sm, out + 15);
  if (!e) e = occupancy(control_step_bf16_kernel, sm, out + 20);
  if (!e) e = occupancy(control_step_head_bf16_kernel, sm, out + 25);
  if (!e) e = occupancy(control_step_tail_bf16_kernel, sm, out + 30);
  return e;
}

// Each launches on `stream` and returns the CUDA error code of the launch
// (0 = ok). P is the (S, P_TOTAL) model library, seq_idx (B,) int32 rows
// of it or null (row 0 for every env). W is the matrix workspace, B ×
// W_TOTAL float32 on a big tree (null at 24 bodies). X is (B, 2, NV, NV)
// float32 (bfloat16 for the _bf16 entries, K2b): written by the head, read
// by the tail. jg is the int table's I_JROW[6·NB], the floats of each of
// J6 and G by subtree, which size a 24-body block's shared memory.
extern "C" int uhc_control_step(const float* P, const int* seq_idx,
                                const int* I, const float* qpos,
                                const float* qvel, const float* act,
                                const float* tb, float* qpos_out,
                                float* qvel_out, float* W, int B,
                                int act_dim, float rfc_rate, int jg,
                                void* stream) {
  return launch(control_step_kernel, false, B, stream, W, jg, P, seq_idx, I,
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
                                  int act_dim, float rfc_rate, int jg,
                                  void* stream) {
  return launch(control_step_f_kernel, true, B, stream, W, jg, P, seq_idx,
                I, qpos, qvel, act, tb, qpos_out, qvel_out, W, act_dim,
                rfc_rate, vfx, ksc);
}

extern "C" int uhc_control_step_head(const float* P, const int* seq_idx,
                                     const int* I, const float* qpos,
                                     const float* qvel, const float* act,
                                     const float* tb, float* qpos_out,
                                     float* qvel_out, float* W, float* X,
                                     int B, int act_dim, float rfc_rate,
                                     int jg, void* stream) {
  return launch(control_step_head_kernel, false, B, stream, W, jg, P,
                seq_idx, I, qpos, qvel, act, tb, qpos_out, qvel_out, W,
                act_dim, rfc_rate, X);
}

extern "C" int uhc_control_step_tail(const float* P, const int* seq_idx,
                                     const int* I, const float* qpos,
                                     const float* qvel, const float* act,
                                     const float* tb, float* qpos_out,
                                     float* qvel_out, float* W, float* X,
                                     int B, int act_dim, float rfc_rate,
                                     int jg, void* stream) {
  return launch(control_step_tail_kernel, false, B, stream, W, jg, P,
                seq_idx, I, qpos, qvel, act, tb, qpos_out, qvel_out, W,
                act_dim, rfc_rate, X);
}

extern "C" int uhc_control_step_bf16(const float* P, const int* seq_idx,
                                     const int* I, const float* qpos,
                                     const float* qvel, const float* act,
                                     const float* tb, float* qpos_out,
                                     float* qvel_out, float* W, int B,
                                     int act_dim, float rfc_rate,
                                     int jg, void* stream) {
  return launch(control_step_bf16_kernel, false, B, stream, W, jg, P,
                seq_idx, I, qpos, qvel, act, tb, qpos_out, qvel_out, W,
                act_dim, rfc_rate);
}

extern "C" int uhc_control_step_head_bf16(
    const float* P, const int* seq_idx, const int* I, const float* qpos,
    const float* qvel, const float* act, const float* tb, float* qpos_out,
    float* qvel_out, float* W, void* X, int B, int act_dim, float rfc_rate,
    int jg, void* stream) {
  return launch(control_step_head_bf16_kernel, false, B, stream, W, jg, P,
                seq_idx, I, qpos, qvel, act, tb, qpos_out, qvel_out, W,
                act_dim, rfc_rate, (float*)X);
}

extern "C" int uhc_control_step_tail_bf16(
    const float* P, const int* seq_idx, const int* I, const float* qpos,
    const float* qvel, const float* act, const float* tb, float* qpos_out,
    float* qvel_out, float* W, void* X, int B, int act_dim, float rfc_rate,
    int jg, void* stream) {
  return launch(control_step_tail_bf16_kernel, false, B, stream, W, jg, P,
                seq_idx, I, qpos, qvel, act, tb, qpos_out, qvel_out, W,
                act_dim, rfc_rate, (float*)X);
}
#else
// Host build: every env on one thread, in order, with one workspace that
// each env reuses (shared memory itself at 24 bodies, sized by the int
// table's J6 / G).
template <bool EXT, bool BF16 = false>
static int run_host(const float* P, const int* seq_idx, const int* I,
                    const float* qpos, const float* qvel, const float* act,
                    const float* tb, float* qpos_out, float* qvel_out, int B,
                    int act_dim, float rfc_rate, int part, float* X,
                    const float* vfx, const float* ksc) {
  std::vector<float> sm(smem_floats(EXT, I[I_JROW + 6 * NB]));
  std::vector<float> wbuf(BIG_TREE ? W_TOTAL : 0);
  float* ws = BIG_TREE ? wbuf.data() : sm.data();
  for (int env = 0; env < B; ++env)
    control_step_env<EXT, BF16>(env, 0, 1, sm.data(), ws, P, seq_idx, I,
                                qpos, qvel, act, tb, qpos_out, qvel_out,
                                act_dim, rfc_rate, part, X, vfx, ksc);
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

extern "C" int uhc_control_step_bf16_host(
    const float* P, const int* seq_idx, const int* I, const float* qpos,
    const float* qvel, const float* act, const float* tb, float* qpos_out,
    float* qvel_out, int B, int act_dim, float rfc_rate) {
  return run_host<false, true>(P, seq_idx, I, qpos, qvel, act, tb,
                               qpos_out, qvel_out, B, act_dim, rfc_rate,
                               PART_FULL, nullptr, nullptr, nullptr);
}

extern "C" int uhc_control_step_head_bf16_host(
    const float* P, const int* seq_idx, const int* I, const float* qpos,
    const float* qvel, const float* act, const float* tb, float* qpos_out,
    float* qvel_out, void* X, int B, int act_dim, float rfc_rate) {
  return run_host<false, true>(P, seq_idx, I, qpos, qvel, act, tb,
                               qpos_out, qvel_out, B, act_dim, rfc_rate,
                               PART_HEAD, (float*)X, nullptr, nullptr);
}

// K2b's rounding alone over n floats, as 16-bit words (the host build's
// check of bf16_bits against torch's .to(bfloat16)).
extern "C" int uhc_bf16_bits_host(const float* x, uint16_t* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = bf16_bits(x[i]);
  return 0;
}

extern "C" int uhc_control_step_tail_bf16_host(
    const float* P, const int* seq_idx, const int* I, const float* qpos,
    const float* qvel, const float* act, const float* tb, float* qpos_out,
    float* qvel_out, void* X, int B, int act_dim, float rfc_rate) {
  return run_host<false, true>(P, seq_idx, I, qpos, qvel, act, tb,
                               qpos_out, qvel_out, B, act_dim, rfc_rate,
                               PART_TAIL, (float*)X, nullptr, nullptr);
}
#endif
