// The multiresolution hash-grid lookup's per-point arithmetic, shared by its
// forward (hash_encode.cu) and its table gradient (segsum.cu, B1's rows
// stage): the launch's lookups, passed by value, and for one (point, level)
// the corner slots and multilinear weights, computed in registers.
//
// The arithmetic is nvsf_torch/ops/hash_lookup.py::level_cols_weights' in
// f32 and integers: pos = x * res (rounded, never contracted into an FMA),
// c0 = floor(pos), w = pos - c0; corner c adds its offset bits (dim 0 the
// most significant, numpy's meshgrid order) and clamps to [0, res]; a dense
// level indexes c_0 + c_1 (res + 1) + c_2 (res + 1)^2, a hashed one the
// instant-ngp hash with the reference's uint32 wraparound,
// (c_0 ^ c_1 * 2654435761 ^ c_2 * 805459861) mod 2^32, & (T - 1); the
// corner's weight is the product over dims in order of w_d or 1 - w_d.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nvsf {

constexpr int kMaxLookups = 12;
constexpr int kMaxLevels = 16;
constexpr int kMaxFeatures = 32;

// One lookup of a launch: the points x at D columns, into L levels of T
// slots from `table`, written to (or, in the gradient, read from) `out`.
// All int64, so the host packs it as kLookupWords int64 values.
struct HashLookup {
  int64_t x;         // const float*: the points, rows of x_ld floats
  int64_t x_ld;
  int64_t x_off[3];  // the D input dims' float offsets within a row
  int64_t table;     // float*: slot 0 of the lookup (forward: the table it
                     // reads; gradient: its rows scratch, [L * T, F])
  int64_t slot_ld;   // floats between slots
  int64_t feat_ld;   // floats between the features of a slot
  int64_t log2_T;
  int64_t dense;     // bit l set: level l is indexed densely
  int64_t n;         // points
  int64_t out;       // float*: the lookup's first output column
  int64_t out_ld;    // floats between output rows
};
constexpr int kLookupWords = 13;
static_assert(sizeof(HashLookup) == kLookupWords * 8, "packed by the host");

struct HashLookups {
  HashLookup lk[kMaxLookups];
  int res[kMaxLevels];  // grid resolution of each level
  int L;
  int F;                // features a slot
};

// One (lookup, level) of a block: blockIdx.y = lookup * L + level.
struct HashLevel {
  HashLookup lk;  // a copy: the fields a kernel reads stay in registers
  int l;
  int res;
  float fres;
  int64_t T;
  bool dense;
};

__device__ __forceinline__ HashLevel hash_level(const HashLookups& p) {
  HashLevel v;
  const int k = blockIdx.y / p.L;
  v.lk = p.lk[k];
  v.l = blockIdx.y - k * p.L;
  v.res = p.res[v.l];
  v.fres = (float)v.res;
  v.T = (int64_t)1 << v.lk.log2_T;
  v.dense = (v.lk.dense >> v.l) & 1;
  return v;
}

template <int D>
struct HashPoint {
  int c0[D];  // floor of the scaled position, clamped to [-1, res]
  float w[D];  // its fraction
};

template <int D>
__device__ __forceinline__ HashPoint<D> hash_point(const HashLevel& v,
                                                   int64_t n) {
  HashPoint<D> p;
  const float* x = reinterpret_cast<const float*>(v.lk.x) + n * v.lk.x_ld;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float pos = __fmul_rn(__ldg(x + v.lk.x_off[d]), v.fres);
    const float f = floorf(pos);
    p.w[d] = __fsub_rn(pos, f);
    // 32-bit corners: a floor outside [-1, res] clamps its corners to the
    // same ends as the plain version's int64 ones (the conversion
    // saturates; NaN points give NaN weights either way)
    const int c = (int)f;
    p.c0[d] = c < -1 ? -1 : (c > v.res ? v.res : c);
  }
  return p;
}

// Corner u of the point at level v: its slot in [0, T) and its weight.
// A dense level's index is below (res + 1)^D <= T <= 2^31.
template <int D>
__device__ __forceinline__ int hash_corner(const HashPoint<D>& p,
                                           const HashLevel& v, int u,
                                           float* wc) {
  int c[D];
  float w = 1.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int o = (u >> (D - 1 - d)) & 1;
    int cd = p.c0[d] + o;
    cd = cd < 0 ? 0 : cd;
    cd = cd > v.res ? v.res : cd;
    c[d] = cd;
    const float wd = o ? p.w[d] : __fsub_rn(1.f, p.w[d]);
    w = d == 0 ? wd : __fmul_rn(w, wd);
  }
  *wc = w;
  if (v.dense) {
    const int r1 = v.res + 1;
    int idx = c[0], stride = 1;
#pragma unroll
    for (int d = 1; d < D; ++d) {
      stride *= r1;
      idx += c[d] * stride;
    }
    return idx;
  }
  constexpr uint32_t kPrimes[3] = {1u, 2654435761u, 805459861u};
  uint32_t h = (uint32_t)c[0];
#pragma unroll
  for (int d = 1; d < D; ++d) h ^= (uint32_t)c[d] * kPrimes[d];
  return (int)(h & (uint32_t)(v.T - 1));
}

}  // namespace nvsf
