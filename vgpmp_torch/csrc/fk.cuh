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

// Rotation R[k] (row-major 3x3) and translation t[k] of every chain frame
// k = 0..DOF for the configuration q[0..DOF).
template <int DOF, bool CRAIG>
__device__ __forceinline__ void fk_chain(const float* __restrict__ q,
                                         const float* __restrict__ robot,
                                         float (&R)[DOF + 1][9], float (&t)[DOF + 1][3]) {
  const float* base = robot + 6 * DOF;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[0][3 * i + j] = base[4 * i + j];
    t[0][i] = base[4 * i + 3];
  }
#pragma unroll
  for (int j = 0; j < DOF; ++j) {
    const float* c = robot + 6 * j;
    const float ca = c[0], sa = c[1];
    const float ang = q[j] + c[2];
    const float co = cosf(ang), s = sinf(ang);
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
        R[j + 1][3 * i + k] = R[j][3 * i] * Tm[k] + R[j][3 * i + 1] * Tm[3 + k] + R[j][3 * i + 2] * Tm[6 + k];
      t[j + 1][i] = t[j][i] + R[j][3 * i] * p[0] + R[j][3 * i + 1] * p[1] + R[j][3 * i + 2] * p[2];
    }
  }
}

// World centre (x, y, z) of the sphere described by s[0..5); returns its frame.
template <int DOF>
__device__ __forceinline__ int sphere_centre(const float* __restrict__ s,
                                             const float (&R)[DOF + 1][9],
                                             const float (&t)[DOF + 1][3], float& x, float& y,
                                             float& z) {
  const int f = (int)s[0];
  const float ox = s[1], oy = s[2], oz = s[3];
  float Rf[9], tf[3];
#pragma unroll
  for (int k = 0; k <= DOF; ++k) {
    if (k == f) {
#pragma unroll
      for (int i = 0; i < 9; ++i) Rf[i] = R[k][i];
#pragma unroll
      for (int i = 0; i < 3; ++i) tf[i] = t[k][i];
    }
  }
  x = Rf[0] * ox + Rf[1] * oy + Rf[2] * oz + tf[0];
  y = Rf[3] * ox + Rf[4] * oy + Rf[5] * oz + tf[1];
  z = Rf[6] * ox + Rf[7] * oy + Rf[8] * oz + tf[2];
  return f;
}
