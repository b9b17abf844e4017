// The per-ray BVH walk for Hopper (sm_90a): kernel X2 of vimg_tpu_torch's
// BVHTracer (geometry/bvh.py::bvh_trace) and of the cost heatmap.
//
// Replaces: no Pallas kernel. vimg_tpu walks its BVH with XLA
// (vimg_tpu/geometry/bvh.py::bvh_traverse, :341-433, leaves in _leaf_test
// :288-328): every lane in lockstep, next = hit ? node + 1 : skip[node],
// each leaf tested 8 primitives wide by one-hot selects, because a TPU
// lane has no stack and no control flow of its own. Its plain PyTorch
// version is geometry/bvh.py::bvh_traverse.
//
// Design: a thread a ray walks the same preorder skip links over the same
// host-built tables (node_min/max, node_start/count/skip, prim_type/idx,
// verts + tri_vidx, sph_center/radius), with its own loads and branches:
// an inner node whose box it meets goes to node + 1, anything else to
// skip[node]; a leaf whose box it meets tests its count primitives in
// order. Three modes in one kernel (a template): closest, any hit (the
// walk ends at the first leaf that lowers t, as vimg_tpu's early exit
// :407-410) and closest with the reference's cost counter (0.5 a node
// visit, count a tested leaf, summed in float32 in vimg_tpu's order).
//
// It computes what bvh_traverse computes, bit for bit:
//  - inv = 1 / (d == 0 ? 1e-20 : d), an IEEE divide (the library is built
//    with -fmad=false and no fast math, so no product is fused into an
//    add anywhere below);
//  - the box test is XLA's: t0 = max(max(max(near.x, near.y), near.z),
//    minT), t1 = min(min(min(far.x, far.y), far.z), best_t), hit = t0 <=
//    t1, with NaN-propagating min / max (PTX min.NaN / max.NaN, as B3's);
//  - the triangle is geometry/intersect.py::tri_intersect (watertight,
//    pbrt), the sphere sphere_intersect (the robust quadric), each with
//    minT <= t <= best_t, operation for operation in PyTorch's order;
//  - a leaf keeps its first least t (argmin); across leaves only a
//    strictly smaller t replaces the best; on a miss t = inf, prim_id = 0.
//
// What bounds it on this card: dependent loads (node, then primitive
// index, then vertex indices, then vertices) and divergence between the
// rays of a warp, far above both the bytes (48 B a ray plus the tables)
// and the operations (box tests x 25 + triangle tests x 56 + sphere tests
// x 40) of the plain walk's counts. Simple and right first: the tables
// are read through the read-only cache as they lie.
//
// Launch contract: vimg_bvh_walk() launches on the given stream, does not
// synchronise and allocates nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLeafSize = 8;
constexpr int kPrimTri = 0;
constexpr int kPrimSphere = 1;

__device__ __forceinline__ float jmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float jmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

struct Tables {
  const float* node_min;
  const float* node_max;
  const int* node_start;
  const int* node_count;
  const int* node_skip;
  const int* prim_type;
  const int* prim_idx;
  const float* verts;
  const int* tri_vidx;
  const float* sph_center;
  const float* sph_radius;
};

// geometry/intersect.py::tri_intersect for one ray and triangle: returns
// t (inf on a miss) and the weights u (of p0) and v (of p1).
__device__ __forceinline__ float tri_test(const Tables& S, int tri, float ox,
                                          float oy, float oz, float dx0,
                                          float dy0, float dz0, float minT,
                                          float maxT, float& u, float& v) {
  const int i0 = __ldg(S.tri_vidx + 3 * tri);
  const int i1 = __ldg(S.tri_vidx + 3 * tri + 1);
  const int i2 = __ldg(S.tri_vidx + 3 * tri + 2);
  const float a0 = __ldg(S.verts + 3 * i0), a1 = __ldg(S.verts + 3 * i0 + 1),
              a2 = __ldg(S.verts + 3 * i0 + 2);
  const float b0 = __ldg(S.verts + 3 * i1), b1 = __ldg(S.verts + 3 * i1 + 1),
              b2 = __ldg(S.verts + 3 * i1 + 2);
  const float c0 = __ldg(S.verts + 3 * i2), c1 = __ldg(S.verts + 3 * i2 + 1),
              c2 = __ldg(S.verts + 3 * i2 + 2);
  // p - ro, then the axis permutation that makes |d| largest along z
  float q0[3] = {a0 - ox, a1 - oy, a2 - oz};
  float q1[3] = {b0 - ox, b1 - oy, b2 - oz};
  float q2[3] = {c0 - ox, c1 - oy, c2 - oz};
  const float adx = fabsf(dx0), ady = fabsf(dy0), adz = fabsf(dz0);
  const bool kz0 = adx >= ady && adx >= adz;
  const bool kz1 = !kz0 && ady >= adz;
  // kz0: (y, z, x); kz1: (z, x, y); else (x, y, z)
  const int kx = kz0 ? 1 : (kz1 ? 2 : 0);
  const int ky = kz0 ? 2 : (kz1 ? 0 : 1);
  const int kz = kz0 ? 0 : (kz1 ? 1 : 2);
  const float dd[3] = {dx0, dy0, dz0};
  const float dx = dd[kx], dy = dd[ky], dz = dd[kz];
  float p0x = q0[kx], p0y = q0[ky], p0z = q0[kz];
  float p1x = q1[kx], p1y = q1[ky], p1z = q1[kz];
  float p2x = q2[kx], p2y = q2[ky], p2z = q2[kz];
  const float sx = -dx / dz;
  const float sy = -dy / dz;
  const float sz = 1.0f / dz;
  p0x = p0x + sx * p0z;
  p0y = p0y + sy * p0z;
  p1x = p1x + sx * p1z;
  p1y = p1y + sy * p1z;
  p2x = p2x + sx * p2z;
  p2y = p2y + sy * p2z;
  const float e0 = p1x * p2y - p1y * p2x;
  const float e1 = p2x * p0y - p2y * p0x;
  const float e2 = p0x * p1y - p0y * p1x;
  const bool same_sign = !((e0 < 0.0f || e1 < 0.0f || e2 < 0.0f) &&
                           (e0 > 0.0f || e1 > 0.0f || e2 > 0.0f));
  const float det = e0 + e1 + e2;
  bool ok = same_sign && det != 0.0f;
  const float t_scaled = e0 * (p0z * sz) + e1 * (p1z * sz) + e2 * (p2z * sz);
  const float inv_det = det != 0.0f ? 1.0f / det : 0.0f;
  const float t = t_scaled * inv_det;
  ok = ok && t >= minT && t <= maxT;
  // degenerate: cross(p2 - p0, p1 - p0) == 0
  const float ex = c0 - a0, ey = c1 - a1, ez = c2 - a2;
  const float fx = b0 - a0, fy = b1 - a1, fz = b2 - a2;
  const float cx = ey * fz - ez * fy, cy = ez * fx - ex * fz,
              cz = ex * fy - ey * fx;
  ok = ok && !(cx * cx + cy * cy + cz * cz == 0.0f);
  u = e0 * inv_det;
  v = e1 * inv_det;
  return ok ? t : inf_f();
}

// geometry/intersect.py::sphere_intersect for one ray and sphere.
__device__ __forceinline__ float sphere_test(const Tables& S, int s, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float minT,
                                             float maxT) {
  const float fx = ox - __ldg(S.sph_center + 3 * s);
  const float fy = oy - __ldg(S.sph_center + 3 * s + 1);
  const float fz = oz - __ldg(S.sph_center + 3 * s + 2);
  const float r = __ldg(S.sph_radius + s);
  const float a = dx * dx + dy * dy + dz * dz;
  const float b_prime = (-fx) * dx + (-fy) * dy + (-fz) * dz;
  const float c = (fx * fx + fy * fy + fz * fz) - r * r;
  const float k = b_prime / a;
  const float tx = fx + k * dx, ty = fy + k * dy, tz = fz + k * dz;
  const float disc = r * r - (tx * tx + ty * ty + tz * tz);
  const bool has_root = disc >= 0.0f;
  const float sign = b_prime > 0.0f ? 1.0f : -1.0f;
  const float disc_safe = has_root ? jmax(a * disc, 1e-30f) : 1.0f;
  const float q = b_prime + sign * sqrtf(disc_safe);
  const float x0 = c / (q == 0.0f ? 1.0f : q);
  const float x1 = q / a;
  const float t0 = jmin(x0, x1);
  const float t1 = jmax(x0, x1);
  const bool t0_ok = t0 >= minT && t0 <= maxT;
  const bool t1_ok = t1 >= minT && t1 <= maxT;
  const float t = t0_ok ? t0 : t1;
  return has_root && (t0_ok || t1_ok) ? t : inf_f();
}

// kMode: 0 closest, 1 any hit, 2 closest with the cost counter
template <int kMode>
__global__ void __launch_bounds__(kThreads)
    bvh_walk_kernel(Tables S, const float* __restrict__ ro,
                    const float* __restrict__ rd,
                    const float* __restrict__ min_t,
                    const float* __restrict__ max_t, int n_rays, int n_nodes,
                    int n_prims, int n_tris, int n_spheres,
                    float* __restrict__ out_t, int* __restrict__ out_type,
                    int* __restrict__ out_id, float* __restrict__ out_u,
                    float* __restrict__ out_v, uint8_t* __restrict__ out_occ,
                    float* __restrict__ out_cost) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  const float ox = ro[3 * r], oy = ro[3 * r + 1], oz = ro[3 * r + 2];
  const float dx = rd[3 * r], dy = rd[3 * r + 1], dz = rd[3 * r + 2];
  const float ix = 1.0f / (dx == 0.0f ? 1e-20f : dx);
  const float iy = 1.0f / (dy == 0.0f ? 1e-20f : dy);
  const float iz = 1.0f / (dz == 0.0f ? 1e-20f : dz);
  const float mn = min_t[r];
  float best = max_t[r];
  int btype = 0, bid = -1;
  float bu = 0.0f, bv = 0.0f, cost = 0.0f;
  bool occ = false;
  int cur = 0;
  while (cur < n_nodes) {
    const float* lo = S.node_min + 3 * cur;
    const float* hi = S.node_max + 3 * cur;
    const float lx = (__ldg(lo) - ox) * ix, hx = (__ldg(hi) - ox) * ix;
    const float ly = (__ldg(lo + 1) - oy) * iy, hy = (__ldg(hi + 1) - oy) * iy;
    const float lz = (__ldg(lo + 2) - oz) * iz, hz = (__ldg(hi + 2) - oz) * iz;
    const float t0 =
        jmax(jmax(jmax(jmin(lx, hx), jmin(ly, hy)), jmin(lz, hz)), mn);
    const float t1 =
        jmin(jmin(jmin(jmax(lx, hx), jmax(ly, hy)), jmax(lz, hz)), best);
    const bool hit = t0 <= t1;
    const int count = __ldg(S.node_count + cur);
    if (kMode == 2) cost = cost + 0.5f;
    if (hit && count == 0) {
      ++cur;
      continue;
    }
    if (hit) {
      const int start = __ldg(S.node_start + cur);
      float tmin = inf_f(), lu = 0.0f, lv = 0.0f;
      int ltype = 0, lid = 0;
      for (int k = 0; k < count && k < kLeafSize; ++k) {
        const int slot = min(start + k, n_prims - 1);
        const int ptype = __ldg(S.prim_type + slot);
        const int pidx = __ldg(S.prim_idx + slot);
        float t = inf_f(), u = 0.0f, v = 0.0f;
        if (ptype == kPrimTri && n_tris > 0) {
          t = tri_test(S, min(max(pidx, 0), n_tris - 1), ox, oy, oz, dx, dy,
                       dz, mn, best, u, v);
        } else if (ptype == kPrimSphere && n_spheres > 0) {
          t = sphere_test(S, min(max(pidx, 0), n_spheres - 1), ox, oy, oz,
                          dx, dy, dz, mn, best);
        }
        if (t < tmin) {
          tmin = t;
          ltype = ptype;
          lid = pidx;
          lu = u;
          lv = v;
        }
      }
      if (kMode == 2) cost = cost + (float)count;
      if (tmin < best) {
        best = tmin;
        btype = ltype;
        bid = lid;
        bu = lu;
        bv = lv;
        if (kMode == 1 && tmin < inf_f()) {
          occ = true;
          break;
        }
      }
    }
    cur = __ldg(S.node_skip + cur);
  }
  if (kMode == 1) {
    out_occ[r] = occ ? 1 : 0;
    return;
  }
  const bool found = bid >= 0;
  out_t[r] = found ? best : inf_f();
  out_type[r] = btype;
  out_id[r] = found ? bid : 0;
  out_u[r] = bu;
  out_v[r] = bv;
  if (kMode == 2) out_cost[r] = cost;
}

}  // namespace

extern "C" int vimg_bvh_walk(
    const float* node_min, const float* node_max, const int* node_start,
    const int* node_count, const int* node_skip, const int* prim_type,
    const int* prim_idx, const float* verts, const int* tri_vidx,
    const float* sph_center, const float* sph_radius, const float* ro,
    const float* rd, const float* min_t, const float* max_t, int n_rays,
    int n_nodes, int n_tris, int n_spheres, int mode, float* t, int* ptype,
    int* pidx, float* u, float* v, uint8_t* occ, float* cost,
    cudaStream_t stream) {
  if (n_rays <= 0) return 0;
  Tables S{node_min, node_max, node_start, node_count, node_skip, prim_type,
           prim_idx, verts, tri_vidx, sph_center, sph_radius};
  const int n_prims = n_tris + n_spheres;
  const dim3 grid((n_rays + kThreads - 1) / kThreads);
  if (mode == 1) {
    bvh_walk_kernel<1><<<grid, kThreads, 0, stream>>>(
        S, ro, rd, min_t, max_t, n_rays, n_nodes, n_prims, n_tris, n_spheres,
        t, ptype, pidx, u, v, occ, cost);
  } else if (mode == 2) {
    bvh_walk_kernel<2><<<grid, kThreads, 0, stream>>>(
        S, ro, rd, min_t, max_t, n_rays, n_nodes, n_prims, n_tris, n_spheres,
        t, ptype, pidx, u, v, occ, cost);
  } else {
    bvh_walk_kernel<0><<<grid, kThreads, 0, stream>>>(
        S, ro, rd, min_t, max_t, n_rays, n_nodes, n_prims, n_tris, n_spheres,
        t, ptype, pidx, u, v, occ, cost);
  }
  return (int)cudaGetLastError();
}
