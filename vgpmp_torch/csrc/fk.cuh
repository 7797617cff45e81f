// Device code shared by K1 (k1_collision.cu) and K3 (k3_clearance.cu): the DH
// chain and the sphere centres, written term for term as the plain
// structure-of-arrays FK (vgpmp_torch/kinematics/dh.py:sphere_positions, after
// vgpmp_tpu/kinematics/dh.py:sphere_positions), so that a kernel differs from
// the plain version by fused multiply-adds only.
//
// robot: per joint (cos alpha, sin alpha, twist, pa, pb, pc) x DOF, then the
// base pose's top 3x4 rows, row-major. The link translation is (pa, pb, pc)
// for Craig DH and (pa cos, pa sin, pc) for classic DH, as the plain version
// folds it. spheres: per sphere (frame, ox, oy, oz, r).
#pragma once

#include <cuda_runtime.h>

// One DH step: frame (Rn, tn) = frame (Rc, tc) composed with joint j's
// transform, from co = cos and s = sin of the joint's angle q_j + twist. c
// points at the joint's six constants. Every FK of this file goes through
// here, so all of them round alike.
template <bool CRAIG>
__device__ __forceinline__ void dh_step_cs(const float* __restrict__ c, float co, float s,
                                           const float (&Rc)[9], const float (&tc)[3],
                                           float (&Rn)[9], float (&tn)[3]) {
  const float ca = c[0], sa = c[1];
  float Tm[9], p[3];
  if (CRAIG) {
    Tm[0] = co;      Tm[1] = -s;      Tm[2] = 0.f;
    Tm[3] = s * ca;  Tm[4] = co * ca; Tm[5] = -sa;
    Tm[6] = s * sa;  Tm[7] = co * sa; Tm[8] = ca;
    p[0] = c[3]; p[1] = c[4]; p[2] = c[5];
  } else {
    Tm[0] = co;  Tm[1] = -s * ca; Tm[2] = s * sa;
    Tm[3] = s;   Tm[4] = co * ca; Tm[5] = -co * sa;
    Tm[6] = 0.f; Tm[7] = sa;      Tm[8] = ca;
    p[0] = c[3] * co; p[1] = c[3] * s; p[2] = c[5];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      Rn[3 * i + k] = Rc[3 * i] * Tm[k] + Rc[3 * i + 1] * Tm[3 + k] + Rc[3 * i + 2] * Tm[6 + k];
    tn[i] = tc[i] + Rc[3 * i] * p[0] + Rc[3 * i + 1] * p[1] + Rc[3 * i + 2] * p[2];
  }
}

// The joint's angle, and its cos and sin, as every FK of this file takes them
__device__ __forceinline__ void joint_cos_sin(const float* __restrict__ c, float qj, float& co,
                                              float& s) {
  const float ang = qj + c[2];
  co = cosf(ang);
  s = sinf(ang);
}

// One DH step at the joint angle q_j
template <bool CRAIG>
__device__ __forceinline__ void dh_step(const float* __restrict__ c, float qj, const float (&Rc)[9],
                                        const float (&tc)[3], float (&Rn)[9], float (&tn)[3]) {
  float co, s;
  joint_cos_sin(c, qj, co, s);
  dh_step_cs<CRAIG>(c, co, s, Rc, tc, Rn, tn);
}

// Block-level FK: the same chain for one configuration, with every frame
// written to shared memory as soon as it is known, so the thread holds two
// frames and not DOF + 1. Element e of frame k (e = 0..8 the rotation,
// row-major; 9..11 the translation) of the block's local configuration c goes
// to frames[(12 * k + e) * stride + c]: the threads of a warp, on consecutive
// c, write and later read consecutive words. Pass frames + c.
constexpr int FK_FRAME = 12;

// The chain from the joints' cos and sin: cos_sin(j, co, s) gives joint j's.
template <int DOF, bool CRAIG, class CosSin>
__device__ __forceinline__ void fk_chain_to_shared_cs(CosSin cos_sin,
                                                      const float* __restrict__ robot,
                                                      float* __restrict__ frames, int stride) {
  const float* base = robot + 6 * DOF;
  float Rc[9], tc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) Rc[3 * i + j] = base[4 * i + j];
    tc[i] = base[4 * i + 3];
  }
#pragma unroll
  for (int j = 0; j <= DOF; ++j) {
    float* F = frames + FK_FRAME * j * stride;
#pragma unroll
    for (int e = 0; e < 9; ++e) F[e * stride] = Rc[e];
#pragma unroll
    for (int e = 0; e < 3; ++e) F[(9 + e) * stride] = tc[e];
    if (j < DOF) {
      float co, s, Rn[9], tn[3];
      cos_sin(j, co, s);
      dh_step_cs<CRAIG>(robot + 6 * j, co, s, Rc, tc, Rn, tn);
#pragma unroll
      for (int e = 0; e < 9; ++e) Rc[e] = Rn[e];
#pragma unroll
      for (int e = 0; e < 3; ++e) tc[e] = tn[e];
    }
  }
}

template <int DOF, bool CRAIG>
__device__ __forceinline__ void fk_chain_to_shared(const float* __restrict__ q,
                                                   const float* __restrict__ robot,
                                                   float* __restrict__ frames, int stride) {
  float qj[DOF];
#pragma unroll
  for (int j = 0; j < DOF; ++j) qj[j] = q[j];
  fk_chain_to_shared_cs<DOF, CRAIG>(
      [&](int j, float& co, float& s) { joint_cos_sin(robot + 6 * j, qj[j], co, s); }, robot,
      frames, stride);
}

// World centre of a sphere at offset (ox, oy, oz) in frame f, from the frames
// that fk_chain_to_shared wrote; the sum runs in the plain version's order.
__device__ __forceinline__ void sphere_centre_shared(const float* __restrict__ frames, int stride,
                                                     int f, float ox, float oy, float oz, float& x,
                                                     float& y, float& z) {
  const float* F = frames + FK_FRAME * f * stride;
  x = F[0] * ox + F[stride] * oy + F[2 * stride] * oz + F[9 * stride];
  y = F[3 * stride] * ox + F[4 * stride] * oy + F[5 * stride] * oz + F[10 * stride];
  z = F[6 * stride] * ox + F[7 * stride] * oy + F[8 * stride] * oz + F[11 * stride];
}
