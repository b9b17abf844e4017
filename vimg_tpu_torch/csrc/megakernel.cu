// Persistent-path megakernel for Hopper (sm_90a): the MIS and material
// integrators of vimg_tpu_torch as one CUDA kernel, in two modes.
//
// Replaces: vimg_tpu/render/mega/kernel.py::_make_kernel (kernel.py:404,
// launched by _build_renderer through pl.pallas_call), together with the
// shading helpers of vimg_tpu/render/mega/shade.py and v3.py, which become
// the device functions below.
// - B1, analytic mode (Analytic below, vimg_mega_render): <= 64 triangles
//   without vertex normals and <= 256 spheres, all tested densely.
// - B2, mesh mode (Mesh below, vimg_mega_render_mesh): more than 64
//   triangles, or any with vertex normals. The TPU kernel walks the binary
//   skip-link cluster tree in-kernel (trace_mesh kernel.py:641,
//   trace_mesh_stack :885, trace_mesh_defer :1148; the three give the
//   same hits); here the warp runs the warp-cooperative skip walk of
//   cluster_walk.cuh (kernel B4's device code) over the same tables, a
//   lane's nodes per lane and the warp's leaves together, tests the
//   spheres densely beside it and merges them as the tracer does. The TPU kernel's
//   VMEM residency and per-leaf DMA streaming have no counterpart: every
//   table lives in global memory.
//
// Design: persistent warps over pixel groups, one lane a pixel. The launch
// holds the card's resident blocks; each warp takes groups of 32 pixels
// (consecutive in analytic mode, an 8 x 4 tile in mesh mode) from a global
// counter. Within a group a lane runs its pixel's spp paths in sample order
// through a flat loop: each iteration traces one closest-hit segment (with
// its NEE shadow ray and BSDF sample) on every lane that has work, and a
// lane whose path ends adds it to the pixel's sum and starts its next
// sample at the next iteration (the TPU kernel's per-lane regeneration,
// kernel.py:1651-1671). So a warp runs as many iterations for a group as
// its busiest lane has segments, not the sum over samples of each sample's
// longest path. One integrator body serves
// both modes, templated on the geometry policy. Every step follows the
// plain PyTorch version (vimg_tpu_torch/render/integrators.py, a port of
// vimg_tpu/render/integrators.py, over the SoA tracer in analytic mode and
// the cluster tracer's skip walk in mesh mode) operation for operation: the
// same counter RNG keys (pixel, sample, bounce, draw), the Russian-roulette
// key d drawn after the bounce (the loop integrator's order, not the
// wavefront's), host-packed triangle normals/areas, the same NaN/overflow
// guards, and barycentric triangle hit points u*p0 + v*p1 + w*p2. The TPU
// kernel's mesh mode takes ro + t*rd instead (kernel.py:627-634); this
// kernel keeps the loop integrator's rule in both modes, which is what
// lets it agree with its plain version per sample. JAX's maximum/minimum
// propagate NaN, so jmax/jmin below do too (fmaxf would drop it). The file
// is built with -fmad=false and without fast math, so + - * / and sqrt
// round like the eager PyTorch version; transcendentals (sin, cos, tan,
// log, pow) may differ from it by a few ulp. The clearcoat sampler ports
// bsdf/disney's jnp.power as powf (shade.py's v3.powf exp/log form is not
// used).
//
// What bounds it on this card. Analytic mode: the scene tables are a few
// KB (<= 64 tris, <= 256 spheres/materials/lights) and stay in L1/L2, so
// memory traffic is negligible. The limits are registers (a Disney sample plus two
// evaluations per segment in one thread; spills go to local memory) and
// divergence: lanes pick different lobes within an iteration, and a group
// waits for its busiest pixel. Mesh mode adds the walk: each node step
// loads a node that depends on the previous one (latency), and the rays of
// a warp visit different nodes (divergence), as in B3/B4; the walk state
// adds registers to B1's. The 100k and 500k terrains' tables (about 16 and
// 78 MB with the per-triangle shading rows) meet the 50 MB L2.
//
// Launch contract: vimg_mega_render() and vimg_mega_render_mesh() launch
// on the given stream, do not synchronise and allocate nothing; they return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_walk.cuh"

#define F_MIS 1
#define F_DOF 2
#define F_BG_EMISSIVE 4
#define F_SHEEN 8
#define F_CLEAR 16
#define F_SPEC_TRANS 32

#define MAT_LAMBERTIAN 0
#define MAT_DIELECTRIC 1
#define MAT_DIFFUSE_LIGHT 2
#define MAT_PRINCIPLED 3
#define LIGHT_TRI 0
#define LIGHT_SPHERE 1
#define TRI_HAS_NORMALS 1

#define MS_IOR 0
#define MS_SPEC_TRANS 1
#define MS_SUBSURFACE 2
#define MS_SPECULAR 3
#define MS_SPEC_TINT 4
#define MS_ANISO 5
#define MS_SHEEN 6
#define MS_SHEEN_TINT 7
#define MS_CLEARCOAT 8
#define MS_CLEARCOAT_GLOSS 9
#define MS_METALLIC 10
#define MS_ROUGHNESS 11

#define DRAW_CAMERA_LENS 0u
#define DRAW_LIGHT_SAMPLE 2u
#define DRAW_BSDF_SAMPLE 4u
#define DRAW_ROULETTE 6u

// Python float64 constants rounded to float32, as the PyTorch version's
// scalar operands are
#define K_PI ((float)3.141592653589793)
#define K_TWO_PI ((float)6.283185307179586)
#define K_FOUR_PI ((float)12.566370614359172)
#define K_INV_PI ((float)0.3183098861837907)
#define K_INV_4PI ((float)0.07957747154594767)
#define K_125_INV_PI ((float)0.3978873577297384)
#define K_CC_R0 ((float)0.04)
#define K_ONE_M_CC_R0 ((float)0.96)
#define MIN_T 1e-4f
#define SHADOW_EPS 1e-4f
#define ROULETTE_THRESHOLD 5
#define ROULETTE_CLAMP 0.95f

struct Tables {
  const float* tri_c;       // nt x 12: plane n, d0, m1, c1, m2, c2 (analytic)
  const float* tri_v;       // nt x 16: p0, p1, p2, unit n_g, area, pad
  const float* sph;         // ns x 8: center, r^2, |c|^2, radius, pad
  const int* prim_mat;      // nt + ns material ids (tris first)
  const int* mat_type;      // per material
  const float* mat_base;    // x 3 (constant textures resolved)
  const float* mat_sc;      // x 12
  const float* light_rows;  // nl x 32 (tri: p0 p1 p2 n area emit n0 n1 n2;
                            //          sphere: center radius emit)
  const int* light_type;    // nl
  const float* cam;         // 24: see kernel.py::_cam_table
  // mesh mode only (cluster_walk.cuh tables, ClusterData's packing)
  const float* node_aabb;   // n_nodes x 8 (padded)
  const int* node_cid;      // n_nodes (padded)
  const int* node_skip;     // n_nodes (padded)
  const float* ctri;        // clusters x 64 x 16 triangle rows
  const int* perm;          // clusters x 64: hit slot -> triangle id
  const float* vnormals;    // nv x 3 vertex normals
  const int* tri_vidx;      // nt x 3 vertex ids
  const int* tri_flags;     // nt (TRI_HAS_NORMALS: smooth shading)
  int nt, ns, nl, W, H, spp, max_depth, sample_offset, flags, n_nodes;
  // the launch shades pixel groups [group_begin, group_end); the caller
  // presets the group counter to group_begin
  int group_begin, group_end;
};

// ---------------------------------------------------------------------------
// scalar helpers with JAX/PyTorch NaN semantics
// ---------------------------------------------------------------------------

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fffffff); }
__device__ __forceinline__ bool isnanf_(float a) { return a != a; }
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnanf_(a) || isnanf_(b)) ? qnan() : (a > b ? a : b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnanf_(a) || isnanf_(b)) ? qnan() : (a < b ? a : b);
}
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}
__device__ __forceinline__ float pow5(float x) {
  float x2 = x * x;
  return x2 * x2 * x;
}

// ---------------------------------------------------------------------------
// 3-vectors; dot sums (x + y) + z like vimg_tpu.core.math.dot
// ---------------------------------------------------------------------------

struct V3 { float x, y, z; };

__device__ __forceinline__ V3 v3(float x, float y, float z) { V3 r = {x, y, z}; return r; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return v3(s * a.x, s * a.y, s * a.z); }
__device__ __forceinline__ V3 operator/(V3 a, float s) { return v3(a.x / s, a.y / s, a.z / s); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 normalize(V3 a) {
  float n2 = dot(a, a);
  float inv = 1.0f / sqrtf(jmax(n2, 1e-38f));
  return a * (n2 > 0.0f ? inv : 0.0f);
}
__device__ __forceinline__ V3 ld3(const float* p) { return v3(p[0], p[1], p[2]); }

// Tangent/bitangent for unit normal n (vimg_tpu.core.math.onb_from_normal)
__device__ __forceinline__ void onb_from_normal(V3 n, V3& u, V3& v) {
  if (n.z < -0.9999999f) {
    u = v3(0.0f, -1.0f, 0.0f);
    v = v3(-1.0f, 0.0f, 0.0f);
    return;
  }
  float a = 1.0f / jmax(1.0f + n.z, 1e-7f);
  float b = -n.x * n.y * a;
  u = v3(1.0f - n.x * n.x * a, b, -n.x);
  v = v3(b, 1.0f - n.y * n.y * a, -n.y);
}
__device__ __forceinline__ V3 onb_to_world(V3 u, V3 v, V3 w, V3 vec) {
  return u * vec.x + v * vec.y + w * vec.z;
}
__device__ __forceinline__ V3 world_to_onb(V3 u, V3 v, V3 w, V3 vec) {
  return v3(dot(vec, u), dot(vec, v), dot(vec, w));
}

// ---------------------------------------------------------------------------
// counter RNG: PCG4D, native uint32 (vimg_tpu.core.rng), in rng.cuh
// ---------------------------------------------------------------------------

#include "rng.cuh"

// ---------------------------------------------------------------------------
// warps (vimg_tpu.core.warps)
// ---------------------------------------------------------------------------

__device__ __forceinline__ V3 warp_dir(float phi, float cos_t) {
  float sin_t = sqrtf(jmax(1.0f - cos_t * cos_t, 0.0f));
  return v3(cosf(phi) * sin_t, sinf(phi) * sin_t, cos_t);
}
__device__ __forceinline__ V3 sample_sphere(float r1, float r2) {
  return warp_dir(K_TWO_PI * r1, 2.0f * r2 - 1.0f);
}
__device__ __forceinline__ V3 sample_sphere_cap(float r1, float r2, float cmax) {
  return warp_dir(K_TWO_PI * r1, cmax + (1.0f - cmax) * r2);
}
__device__ __forceinline__ V3 sample_hemisphere_cosine(float r1, float r2) {
  return warp_dir(K_TWO_PI * r1, sqrtf(r2));
}
__device__ __forceinline__ void sample_triangle_uv(float r1, float r2, float& u, float& v) {
  if (r1 < r2) {
    u = r1 * 0.5f;
    v = r2 - u;
  } else {
    v = r2 * 0.5f;
    u = r1 - v;
  }
}

// ---------------------------------------------------------------------------
// intersection: port of vimg_tpu_torch.geometry.soa_intersect._trace_impl
// ---------------------------------------------------------------------------

struct Hit {
  float t;     // +inf on miss
  int id;      // -1 on miss; tris 0..nt-1, spheres nt..nt+ns-1
  float bu, bv;
};

// No hit yet, searching up to t
__device__ __forceinline__ Hit no_hit(float t) {
  Hit h;
  h.t = t;
  h.id = -1;
  h.bu = 0.0f;
  h.bv = 0.0f;
  return h;
}

// The dense sphere loop of the SoA tracer, continuing from the best hit h
// (its t bounds the test). Returns true on an any-hit.
__device__ __forceinline__ bool sphere_loop(const Tables& S, V3 ro, V3 rd,
                                            float minT, Hit& h, bool any_hit) {
  float ro_rd = ro.x * rd.x + ro.y * rd.y + ro.z * rd.z;
  float ro2 = ro.x * ro.x + ro.y * ro.y + ro.z * ro.z;
  float rd2 = rd.x * rd.x + rd.y * rd.y + rd.z * rd.z;
  bool rd2_bad = rd2 < 1e-30f;
  for (int j = 0; j < S.ns; ++j) {
    const float* s = S.sph + 8 * j;
    float ro_c = ro.x * s[0] + ro.y * s[1] + ro.z * s[2];
    float rd_c = rd.x * s[0] + rd.y * s[1] + rd.z * s[2];
    float b_prime = rd_c - ro_rd;
    float cc = ro2 - 2.0f * ro_c + s[4] - s[3];
    float disc4 = b_prime * b_prime - rd2 * cc;
    bool has = disc4 >= 0.0f;
    float sq = sqrtf(has ? jmax(disc4, 1e-30f) : 1.0f);
    float q = b_prime + (b_prime > 0.0f ? 1.0f : -1.0f) * sq;
    bool q_bad = fabsf(q) < 1e-30f;
    float x0 = q_bad ? -1.0f : cc / q;
    float x1 = rd2_bad ? -1.0f : q / rd2;
    float t0 = jmin(x0, x1);
    float t1 = jmax(x0, x1);
    bool t0_ok = t0 >= minT && t0 < h.t;
    bool t1_ok = t1 >= minT && t1 < h.t;
    float t = t0_ok ? t0 : t1;
    if (has && !rd2_bad && (t0_ok || t1_ok)) {
      h.id = S.nt + j;
      h.t = t;
      if (any_hit) return true;
    }
  }
  return false;
}

__device__ Hit trace(const Tables& S, V3 ro, V3 rd, float minT, float maxT,
                     bool any_hit) {
  Hit h = no_hit(maxT);
  for (int i = 0; i < S.nt; ++i) {
    const float* c = S.tri_c + 12 * i;
    float ro_n = ro.x * c[0] + ro.y * c[1] + ro.z * c[2];
    float rd_n = rd.x * c[0] + rd.y * c[1] + rd.z * c[2];
    bool par = fabsf(rd_n) < 1e-22f;
    float t = (c[3] - ro_n) / (par ? 1.0f : rd_n);
    float u = ro.x * c[4] + ro.y * c[5] + ro.z * c[6] - c[7]
              + t * (rd.x * c[4] + rd.y * c[5] + rd.z * c[6]);
    float v = ro.x * c[8] + ro.y * c[9] + ro.z * c[10] - c[11]
              + t * (rd.x * c[8] + rd.y * c[9] + rd.z * c[10]);
    if (!par && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= minT &&
        t < h.t) {
      h.id = i;
      h.bu = u;
      h.bv = v;
      h.t = t;
      if (any_hit) return h;
    }
  }
  if (S.ns > 0 && sphere_loop(S, ro, rd, minT, h, any_hit)) return h;
  if (h.id < 0) h.t = __int_as_float(0x7f800000);
  return h;
}

// shading data of the surviving hit (intersect.hit_info, constant-colour
// path: ONB frame of the shading normal n_s; n_g the geometric normal)
struct HitInfo {
  int mat;
  V3 p, ns, ng, tangent, bitangent;
};

// triangle and sphere shading (intersect._tri_hit_info / _sphere_hit_info):
// barycentric hit point, host-packed n_g, n_s interpolated from the vertex
// normals on TRI_HAS_NORMALS triangles (mesh mode only)
template <bool kSmooth>
__device__ HitInfo hit_info(const Tables& S, V3 ro, V3 rd, const Hit& h) {
  HitInfo hi;
  hi.mat = S.prim_mat[h.id];
  if (h.id < S.nt) {
    const float* tv = S.tri_v + 16 * h.id;
    // HitResult stores u = weight of p0, v = weight of p1
    float u = 1.0f - h.bu - h.bv;
    float v = h.bu;
    float w = 1.0f - u - v;
    V3 p0 = ld3(tv), p1 = ld3(tv + 3), p2 = ld3(tv + 6);
    hi.p = u * p0 + v * p1 + w * p2;
    hi.ng = ld3(tv + 9);
    hi.ns = hi.ng;
    if (kSmooth && (S.tri_flags[h.id] & TRI_HAS_NORMALS)) {
      const int* vi = S.tri_vidx + 3 * h.id;
      hi.ns = normalize(u * ld3(S.vnormals + 3 * vi[0]) +
                        v * ld3(S.vnormals + 3 * vi[1]) +
                        w * ld3(S.vnormals + 3 * vi[2]));
    }
  } else {
    const float* s = S.sph + 8 * (h.id - S.nt);
    hi.p = ro + rd * h.t;
    hi.ng = normalize(hi.p - ld3(s));
    hi.ns = hi.ng;
  }
  onb_from_normal(hi.ns, hi.tangent, hi.bitangent);
  return hi;
}

// ---------------------------------------------------------------------------
// geometry policies: what the integrator body traces against
// ---------------------------------------------------------------------------

// analytic mode (B1): every triangle and sphere tested densely in one loop
struct Analytic {
  static constexpr int kStats = 3;  // segments, shadow rays, warp steps
  static constexpr bool kTiled = false;  // groups of 32 consecutive pixels
  static constexpr bool kFlat = true;    // the flat loop (mega_kernel)
  // the traces are per lane: only the lanes with a ray call them
  static constexpr bool kWarpWalk = false;
  // __launch_bounds__'s minimum blocks per SM: 12 cap B1 at 40 registers,
  // and 48 resident warps per SM hide the latency of its spills and of its
  // dependent loads better than 16 warps without spills (the measured
  // table of build variants in PERF_APPENDIX.md)
  static constexpr int kMinBlocks = 12;
  __device__ static Hit closest(const Tables& S, V3 ro, V3 rd, float minT,
                                float maxT, bool, cwalk::Tests&,
                                cwalk::Steps&) {
    return trace(S, ro, rd, minT, maxT, false);
  }
  __device__ static bool occluded(const Tables& S, V3 ro, V3 rd, float minT,
                                  float maxT, bool, cwalk::Tests&,
                                  cwalk::Steps&) {
    return trace(S, ro, rd, minT, maxT, true).id >= 0;
  }
  __device__ static HitInfo info(const Tables& S, V3 ro, V3 rd,
                                 const Hit& h) {
    return hit_info<false>(S, ro, rd, h);
  }
};

// mesh mode (B2): the triangles through the warp-cooperative skip walk of
// the binary cluster tree (cluster_walk.cuh, kernel B4's device code), the
// spheres densely beside it, merged as cluster_trace.merge_spheres merges
// them: a sphere wins only on a strictly smaller t. The walk runs a warp's
// leaves together, so every lane of the warp calls each trace (go says
// whether the lane has a ray).
struct Mesh {
  // + box tests, triangle tests, warp node steps, warp triangle steps
  static constexpr int kStats = 6;
  static constexpr bool kTiled = true;   // 8 x 4 pixel tiles
  // the per-sample loop: all lanes of a warp on the same sample keep the
  // walk coherent (the flat loop measured about 20% slower on a 64-spp
  // material frame, PERF.md)
  static constexpr bool kFlat = false;
  static constexpr bool kWarpWalk = true;
  // no register cap: caps of 2-8 blocks per SM measured no faster on main
  // paths 4 and 5 (PERF_APPENDIX.md)
  static constexpr int kMinBlocks = 1;
  __device__ static cwalk::Hit walk(const Tables& S, V3 ro, V3 rd,
                                    float minT, float maxT, bool any_hit,
                                    bool go, cwalk::Tests& n,
                                    cwalk::Steps& st) {
    cwalk::Ray r = cwalk::make_ray(ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, minT);
    cwalk::Hit w;
    w.t = maxT;
    w.u = 0.0f;
    w.v = 0.0f;
    w.slot = -1;
    go = go && cwalk::walks(r, maxT, any_hit);
    cwalk::warp_skip_walk<true, true>(S.node_aabb, S.node_cid, S.node_skip,
                                      S.ctri, S.n_nodes, r, w, any_hit, go,
                                      n, st);
    return w;
  }
  __device__ static Hit closest(const Tables& S, V3 ro, V3 rd, float minT,
                                float maxT, bool go, cwalk::Tests& n,
                                cwalk::Steps& st) {
    cwalk::Hit w = walk(S, ro, rd, minT, maxT, false, go, n, st);
    Hit h = no_hit(__int_as_float(0x7f800000));
    if (w.slot >= 0) {
      h.t = w.t;
      h.id = S.perm[w.slot];
      h.bu = w.u;
      h.bv = w.v;
    }
    if (go && S.ns > 0) {
      Hit s = no_hit(maxT);
      sphere_loop(S, ro, rd, minT, s, false);
      if (s.id >= 0 && s.t < h.t) h = s;
    }
    return h;
  }
  __device__ static bool occluded(const Tables& S, V3 ro, V3 rd, float minT,
                                  float maxT, bool go, cwalk::Tests& n,
                                  cwalk::Steps& st) {
    bool sph = false;
    if (go && S.ns > 0) {
      Hit s = no_hit(maxT);
      sph = sphere_loop(S, ro, rd, minT, s, true);
    }
    return walk(S, ro, rd, minT, maxT, true, go && !sph, n, st).t ==
               -INFINITY ||
           sph;
  }
  __device__ static HitInfo info(const Tables& S, V3 ro, V3 rd,
                                 const Hit& h) {
    return hit_info<true>(S, ro, rd, h);
  }
};

// ---------------------------------------------------------------------------
// lights: port of vimg_tpu_torch.lights.emitters
// ---------------------------------------------------------------------------

struct LightSample {
  V3 rad, wi;
  float pdf, dist, G;
};

__device__ __forceinline__ void sphere_cone(float radius, float d2,
                                            float& cos_max, float& pdf_cone) {
  cos_max = sqrtf(jclip(1.0f - (radius * radius) / jmax(d2, 1e-20f), 0.0f, 1.0f));
  pdf_cone = 1.0f / (K_TWO_PI * jmax(1.0f - cos_max, 1e-12f));
}

__device__ LightSample sample_lights(const Tables& S, V3 look_from, float pick,
                                     float r1, float r2) {
  int idx = (int)(pick * (float)S.nl);
  idx = idx < 0 ? 0 : (idx > S.nl - 1 ? S.nl - 1 : idx);
  const float* row = S.light_rows + 32 * idx;
  LightSample ls;
  V3 zero = v3(0.0f, 0.0f, 0.0f);
  if (S.light_type[idx] == LIGHT_TRI) {
    float u, v;
    sample_triangle_uv(r1, r2, u, v);
    float w = 1.0f - u - v;
    V3 hit_p = ld3(row) * u + ld3(row + 3) * v + ld3(row + 6) * w;
    V3 hit_n = normalize(ld3(row + 16) * u + ld3(row + 19) * v + ld3(row + 22) * w);
    V3 dvec = hit_p - look_from;
    float dist2 = dot(dvec, dvec);
    ls.wi = normalize(dvec);
    ls.pdf = 1.0f / jmax(row[12], 1e-20f);
    ls.G = fabsf(dot(hit_n, -ls.wi)) / jmax(dist2, 1e-20f);
    ls.rad = dot(hit_n, ls.wi) < 0.0f ? ld3(row + 13) : zero;
    ls.dist = sqrtf(dist2);
  } else {
    V3 c = ld3(row);
    float radius = row[3];
    V3 to_c = look_from - c;
    float d2 = dot(to_c, to_c);
    bool inside = d2 <= radius * radius;
    float cos_max, pdf_cone;
    sphere_cone(radius, d2, cos_max, pdf_cone);
    V3 hit_p;
    if (inside) {
      hit_p = sample_sphere(r1, r2) * radius + c;
    } else {
      V3 dir_c = normalize(to_c);
      V3 u_ax, v_ax;
      onb_from_normal(dir_c, u_ax, v_ax);
      V3 zdir = sample_sphere_cap(r1, r2, cos_max);
      hit_p = normalize(onb_to_world(u_ax, v_ax, dir_c, zdir)) * radius + c;
    }
    V3 n = normalize(hit_p - c);
    V3 dvec = hit_p - look_from;
    float dist2 = dot(dvec, dvec);
    ls.wi = normalize(dvec);
    ls.G = fabsf(dot(n, -ls.wi)) / jmax(dist2, 1e-20f);
    float sa = K_FOUR_PI * radius * radius;
    ls.pdf = inside ? 1.0f / sa : pdf_cone * ls.G;
    ls.rad = dot(n, ls.wi) < 0.0f ? ld3(row + 4) : zero;
    ls.dist = sqrtf(dist2);
  }
  ls.pdf = ls.pdf / (float)S.nl;
  return ls;
}

// area pdf of the point p on the hit primitive `id` (emitters.surf_pdf)
__device__ float surf_pdf(const Tables& S, int id, V3 look_from, V3 p, V3 dir) {
  if (id < S.nt) return 1.0f / jmax(S.tri_v[16 * id + 12], 1e-20f);
  const float* s = S.sph + 8 * (id - S.nt);
  V3 c = ld3(s);
  float radius = s[5];
  V3 lc = look_from - c;
  float d2 = dot(lc, lc);
  bool inside = d2 <= radius * radius;
  float sa = K_FOUR_PI * radius * radius;
  float cos_max, pdf_cone;
  sphere_cone(radius, d2, cos_max, pdf_cone);
  V3 n = normalize(p - c);
  float cosine = fabsf(dot(n, -dir));
  V3 pl = p - look_from;
  float dist2 = dot(pl, pl);
  float pdf_out = pdf_cone * cosine / jmax(dist2, 1e-20f);
  return inside ? 1.0f / sa : pdf_out;
}

// ---------------------------------------------------------------------------
// Disney lobes: port of vimg_tpu_torch.materials.disney
// ---------------------------------------------------------------------------

struct Mat {
  int type;
  V3 base;
  float eta, spec_trans, subsurface, specular, spec_tint, anisotropic, sheen,
      sheen_tint, clearcoat, clearcoat_gloss, metallic, roughness;
};

__device__ __forceinline__ Mat load_mat(const Tables& S, int m) {
  Mat p;
  const float* sc = S.mat_sc + 12 * m;
  p.type = S.mat_type[m];
  p.base = ld3(S.mat_base + 3 * m);
  p.eta = sc[MS_IOR];
  p.spec_trans = sc[MS_SPEC_TRANS];
  p.subsurface = sc[MS_SUBSURFACE];
  p.specular = sc[MS_SPECULAR];
  p.spec_tint = sc[MS_SPEC_TINT];
  p.anisotropic = sc[MS_ANISO];
  p.sheen = sc[MS_SHEEN];
  p.sheen_tint = sc[MS_SHEEN_TINT];
  p.clearcoat = sc[MS_CLEARCOAT];
  p.clearcoat_gloss = sc[MS_CLEARCOAT_GLOSS];
  p.metallic = sc[MS_METALLIC];
  p.roughness = sc[MS_ROUGHNESS];
  return p;
}

__device__ __forceinline__ float regularize_alpha(float alpha, bool reg) {
  float widened = jclip(2.0f * alpha, 0.03f, 0.1f);
  return (reg && alpha < 0.1f) ? widened : alpha;
}

__device__ __forceinline__ void anisotropic_alphas(float roughness, float aniso,
                                                   bool clamp_r, float& ax,
                                                   float& ay) {
  float aspect = sqrtf(1.0f - 0.9f * aniso);
  float r = clamp_r ? jclip(roughness, 0.01f, 1.0f) : roughness;
  float r2 = r * r;
  ax = jmax(r2 / aspect, 1e-4f);
  ay = jmax(r2 * aspect, 1e-4f);
}

__device__ __forceinline__ float smith_g(V3 w, float alphax, float alphay,
                                         V3 fu, V3 fv, V3 fw) {
  float lx = dot(w, fu), ly = dot(w, fv), lz = dot(w, fw);
  float lz2 = jmax(lz * lz, 1e-20f);
  float ax = lx * alphax, ay = ly * alphay;
  float a = (ax * ax + ay * ay) / lz2;
  float lam = (sqrtf(1.0f + a) - 1.0f) / 2.0f;
  return 1.0f / (1.0f + lam);
}

__device__ __forceinline__ float ggx_d(V3 h, float alphax, float alphay) {
  float denom = (h.x * h.x) / (alphax * alphax) + (h.y * h.y) / (alphay * alphay)
                + h.z * h.z;
  return 1.0f / (K_PI * alphax * alphay * jmax(denom * denom, 1e-20f));
}

__device__ V3 sample_vndf(V3 din_l, float alphax, float alphay, float r1,
                          float r2) {
  float sign = din_l.z < 0.0f ? -1.0f : 1.0f;
  V3 din = din_l * sign;
  V3 hemi = normalize(v3(alphax * din.x, alphay * din.y, din.z));
  float phi = K_TWO_PI * r1;
  float z = (1.0f - r2) * (1.0f + hemi.z) - hemi.z;
  float sin_t = sqrtf(jclip(1.0f - z * z, 0.0f, 1.0f));
  V3 h = v3(sin_t * cosf(phi), sin_t * sinf(phi), z) + hemi;
  V3 n = normalize(v3(alphax * h.x, alphay * h.y, jmax(h.z, 0.0f)));
  return n * sign;
}

__device__ __forceinline__ float fresnel_dielectric(float n_dot_i, float eta) {
  float n_dot_t_sq = 1.0f - (1.0f - n_dot_i * n_dot_i) / (eta * eta);
  float n_dot_t = sqrtf(jmax(n_dot_t_sq, 0.0f));
  float ni = fabsf(n_dot_i);
  float rs = (ni - eta * n_dot_t) / jmax(ni + eta * n_dot_t, 1e-12f);
  float rp = (eta * ni - n_dot_t) / jmax(eta * ni + n_dot_t, 1e-12f);
  float f = (rs * rs + rp * rp) / 2.0f;
  return n_dot_t_sq < 0.0f ? 1.0f : f;
}

__device__ __forceinline__ float fd_(V3 n, V3 w, float fd90) {
  return 1.0f + (fd90 - 1.0f) * pow5(1.0f - jmax(dot(n, w), 0.0f));
}

__device__ __forceinline__ V3 tint(V3 base) {
  // luminance: dot with the Rec.709 weights
  float lum = base.x * (float)0.212671 + base.y * (float)0.715160 +
              base.z * (float)0.072169;
  return lum > 0.0f ? base / jmax(lum, 1e-12f) : v3(1.0f, 1.0f, 1.0f);
}

__device__ __forceinline__ V3 mirror(V3 dir_in, V3 h) {
  return normalize(-dir_in + (2.0f * dot(dir_in, h)) * h);
}

// ---------------------------------------------------------------------------
// materials: port of vimg_tpu_torch.materials.bsdf
// ---------------------------------------------------------------------------

// bsdf._principled_frame: the frame flips when n_s and n_g disagree about
// the side of dir_in (never where n_s == n_g; negation is exact, as the
// reference's multiply by -1 is)
__device__ __forceinline__ void principled_frame(const HitInfo& hi, V3 dir_in,
                                                 V3& fu, V3& fv, V3& fw) {
  bool flip = (dot(hi.ns, dir_in) * dot(hi.ng, dir_in)) < 0.0f;
  fu = flip ? -hi.tangent : hi.tangent;
  fv = flip ? -hi.bitangent : hi.bitangent;
  fw = flip ? -hi.ns : hi.ns;
}

__device__ __forceinline__ void lobe_weights(const Mat& p, float& wd, float& wc,
                                             float& wm, float& wg) {
  float w_diff = (1.0f - p.metallic) * (1.0f - p.spec_trans);
  float w_clear = 0.25f * p.clearcoat;
  float w_metal = 1.0f - p.spec_trans * (1.0f - p.metallic);
  float w_glass = (1.0f - p.metallic) * p.spec_trans;
  float total = jmax(w_diff + w_clear + w_metal + w_glass, 1e-12f);
  wd = w_diff / total;
  wc = w_clear / total;
  wm = w_metal / total;
  wg = w_glass / total;
}

// Principled mixture eval + pdf (bsdf._principled_eval_pdf)
__device__ void principled_eval_pdf(const Mat& p, int flags, V3 wi, V3 wo,
                                    const HitInfo& hi, bool reg, V3& f,
                                    float& pdf) {
  V3 dir_in = -wi;
  V3 fu, fv, fw;
  principled_frame(hi, dir_in, fu, fv, fw);
  V3 n_g = hi.ng;
  V3 base = p.base;
  V3 half_vec = normalize(dir_in + wo);
  V3 zero3 = v3(0.0f, 0.0f, 0.0f);

  float alphax, alphay;
  anisotropic_alphas(p.roughness, p.anisotropic, true, alphax, alphay);
  alphax = regularize_alpha(alphax, reg);
  alphay = regularize_alpha(alphay, reg);
  float G_in = smith_g(dir_in, alphax, alphay, fu, fv, fw);
  float G = G_in * smith_g(wo, alphax, alphay, fu, fv, fw);

  V3 ev_glass = zero3;
  float pdf_glass = 0.0f;
  if (flags & F_SPEC_TRANS) {
    float in_geo = dot(dir_in, n_g);
    bool reflect = (in_geo * dot(n_g, wo)) >= 0.0f;
    float eta = in_geo >= 0.0f ? p.eta : 1.0f / p.eta;
    V3 gen_h = normalize(dir_in + wo * eta);
    V3 h = reflect ? half_vec : gen_h;
    float h_dot_in = dot(h, dir_in);
    float F = fresnel_dielectric(h_dot_in, eta);
    float d = ggx_d(world_to_onb(fu, fv, fw, h), alphax, alphay);
    float n_in = dot(fw, dir_in);
    float abs_n_in = jmax(fabsf(n_in), 1e-12f);
    if (reflect) {
      ev_glass = base * ((F * d * G) / (4.0f * abs_n_in));
      pdf_glass = (F * d * G_in) / (4.0f * abs_n_in);
    } else {
      float h_dot_out = dot(h, wo);
      float sqrt_denom = h_dot_in + eta * h_dot_out;
      float sd2 = jmax(sqrt_denom * sqrt_denom, 1e-20f);
      float eta_factor = 1.0f / (eta * eta);
      V3 sq_base = v3(sqrtf(jmax(base.x, 0.0f)), sqrtf(jmax(base.y, 0.0f)),
                      sqrtf(jmax(base.z, 0.0f)));
      ev_glass = sq_base * (eta_factor * (1.0f - F) * d * G * eta * eta *
                            fabsf(h_dot_out * h_dot_in) / (abs_n_in * sd2));
      float dh_dout = eta * eta * h_dot_out / sd2;
      pdf_glass = (1.0f - F) * d * G_in *
                  fabsf(dh_dout * h_dot_in / (n_in == 0.0f ? 1e-12f : n_in));
    }
  }

  bool above = (dot(n_g, dir_in) >= 0.0f) && (dot(n_g, wo) >= 0.0f);
  bool under = dot(n_g, dir_in) < 0.0f;

  V3 ev_sheen = zero3;
  if ((flags & F_SHEEN) && above) {
    V3 c_sheen = v3(1.0f - p.sheen_tint, 1.0f - p.sheen_tint,
                    1.0f - p.sheen_tint) + p.sheen_tint * tint(base);
    float cos_out = jmax(dot(fw, wo), 0.0f);
    ev_sheen = c_sheen * (pow5(1.0f - jmax(dot(half_vec, wo), 0.0f)) * cos_out);
  }

  V3 ev_diff = zero3;
  float pdf_diff = 0.0f;
  if (above) {
    float cos_out = jmax(dot(fw, wo), 0.0f);
    float cos_in = jmax(dot(fw, dir_in), 0.0f);
    float h_dot_out = jmax(dot(half_vec, wo), 0.0f);
    float fd90 = 0.5f + 2.0f * p.roughness * h_dot_out * h_dot_out;
    V3 base_diffuse = base * K_INV_PI *
                      (fd_(fw, dir_in, fd90) * fd_(fw, wo, fd90) * cos_out);
    float fss90 = p.roughness * h_dot_out * h_dot_out;
    float fss = fd_(fw, dir_in, fss90) * fd_(fw, wo, fss90) *
                    (1.0f / jmax(cos_out + cos_in, 1e-7f) - 0.5f) + 0.5f;
    V3 ss_diffuse = base * K_125_INV_PI * (fss * cos_out);
    ev_diff = (1.0f - p.subsurface) * base_diffuse + p.subsurface * ss_diffuse;
    pdf_diff = cos_out * K_INV_PI;
  }

  V3 ev_clear = zero3;
  float pdf_clear = 0.0f;
  if ((flags & F_CLEAR) && above) {
    float alpha_g = (1.0f - p.clearcoat_gloss) * 0.1f + p.clearcoat_gloss * 0.001f;
    alpha_g = regularize_alpha(alpha_g, reg);
    float h_dot_out = fabsf(dot(half_vec, wo));
    float fres = K_CC_R0 + K_ONE_M_CC_R0 * pow5(1.0f - h_dot_out);
    float Gc = smith_g(dir_in, 0.25f, 0.25f, fu, fv, fw) *
               smith_g(wo, 0.25f, 0.25f, fu, fv, fw);
    float a2 = alpha_g * alpha_g;
    float hz = world_to_onb(fu, fv, fw, half_vec).z;
    float d = (a2 - 1.0f) / (K_PI * logf(a2) * (1.0f + (a2 - 1.0f) * hz * hz));
    float ev_s = (fres * d * Gc) / (4.0f * jmax(fabsf(dot(fw, dir_in)), 1e-12f));
    ev_clear = v3(ev_s, ev_s, ev_s);
    pdf_clear = (d * fabsf(dot(fw, half_vec))) / (4.0f * jmax(h_dot_out, 1e-12f));
  }

  V3 ev_metal = zero3;
  float pdf_metal = 0.0f;
  if (above) {
    V3 k_s = v3(1.0f - p.spec_tint, 1.0f - p.spec_tint, 1.0f - p.spec_tint) +
             p.spec_tint * tint(base);
    float em1 = p.eta - 1.0f, ep1 = p.eta + 1.0f;
    float r0 = (em1 * em1) / (ep1 * ep1);
    V3 c0 = (p.specular * r0 * (1.0f - p.metallic)) * k_s + p.metallic * base;
    float pw = pow5(1.0f - dot(half_vec, wo));
    V3 fres = c0 + (v3(1.0f, 1.0f, 1.0f) - c0) * pw;
    float d = ggx_d(world_to_onb(fu, fv, fw, half_vec), alphax, alphay);
    float inv4 = 1.0f / (4.0f * jmax(fabsf(dot(fw, dir_in)), 1e-12f));
    ev_metal = fres * (d * G * inv4);
    pdf_metal = d * G_in * inv4;
  }

  float w_diff, w_clear, w_metal, w_glass;
  lobe_weights(p, w_diff, w_clear, w_metal, w_glass);
  float one_m = 1.0f - p.metallic;
  if (under) {
    f = (one_m * p.spec_trans) * ev_glass;
    pdf = pdf_glass;
    return;
  }
  f = ((1.0f - p.spec_trans) * one_m) * ev_diff + (one_m * p.sheen) * ev_sheen +
      (0.25f * p.clearcoat) * ev_clear +
      (1.0f - p.spec_trans * one_m) * ev_metal + (one_m * p.spec_trans) * ev_glass;
  pdf = w_diff * pdf_diff + w_clear * pdf_clear + w_metal * pdf_metal +
        w_glass * pdf_glass;
}

struct Scatter {
  V3 wo;
  float eta;
  bool is_spec, valid;
};

// bsdf.sample_mat; only the picked Principled lobe's direction is computed
// (the PyTorch version evaluates every lobe and selects one: same values)
__device__ Scatter sample_mat(const Mat& p, int flags, V3 wi, const HitInfo& hi,
                              U4 r, bool reg) {
  Scatter s;
  s.wo = v3(0.0f, 0.0f, 0.0f);
  s.eta = 0.0f;
  s.is_spec = false;
  s.valid = false;
  if (p.type == MAT_LAMBERTIAN) {
    bool front = dot(wi, hi.ns) < 0.0f;
    V3 n = front ? hi.ns : -hi.ns;
    V3 u, v;
    onb_from_normal(n, u, v);
    s.wo = onb_to_world(u, v, n, sample_hemisphere_cosine(r.b, r.c));
    s.valid = front;
  } else if (p.type == MAT_DIELECTRIC) {
    float ior = p.eta;
    bool front = dot(wi, hi.ns) < 0.0f;
    V3 n = front ? hi.ns : -hi.ns;
    float cos_i = -dot(wi, n);
    float eta_in = front ? ior : 1.0f / ior;
    float ratio = front ? 1.0f / ior : ior;
    float sin_t_sq = ratio * ratio * (1.0f - cos_i * cos_i);
    float cos_t = sqrtf(jmax(1.0f - sin_t_sq, 0.0f));
    float refl_prob;
    if (front) {
      float q = (1.0f - ior) / (1.0f + ior);
      float r0 = q * q;
      refl_prob = r0 + (1.0f - r0) * pow5(1.0f - cos_i);
    } else if (sin_t_sq > 1.0f) {
      refl_prob = 1.1f;
    } else {
      float q = (ior - 1.0f) / (ior + 1.0f);
      float r0 = q * q;
      refl_prob = r0 + (1.0f - r0) * pow5(1.0f - cos_t);
    }
    if (refl_prob > r.d)
      s.wo = wi - (2.0f * dot(wi, n)) * n;
    else
      s.wo = ratio * wi + (ratio * cos_i - cos_t) * n;
    s.eta = eta_in;
    s.is_spec = true;
    s.valid = true;
  } else if (p.type == MAT_PRINCIPLED) {
    V3 dir_in = -wi;
    V3 fu, fv, fw;
    principled_frame(hi, dir_in, fu, fv, fw);
    V3 n_g = hi.ng;
    float in_geo = dot(n_g, dir_in);
    bool above = in_geo >= 0.0f;
    bool under = in_geo < 0.0f;
    float w_diff, w_clear, w_metal, w_glass;
    lobe_weights(p, w_diff, w_clear, w_metal, w_glass);
    float c1 = w_diff;
    float c2 = c1 + w_clear;
    float c3 = c2 + w_metal;
    float rnd = r.a;
    bool pick_diff = rnd <= c1;
    bool pick_clear = (rnd > c1) && (rnd <= c2);
    bool pick_metal = (rnd > c2) && (rnd <= c3);
    bool pick_glass = !(pick_diff || pick_clear || pick_metal) || under;
    pick_diff = pick_diff && !under;
    pick_clear = pick_clear && !under;
    pick_metal = pick_metal && !under;
    // pruned lobes: the clearcoat slot holds the diffuse sample and the
    // glass slot an invalid metal sample (bsdf._principled_sample)
    bool glass_as_metal = pick_glass && !(flags & F_SPEC_TRANS);
    if (pick_diff || (pick_clear && !(flags & F_CLEAR))) {
      s.wo = onb_to_world(fu, fv, fw, sample_hemisphere_cosine(r.b, r.c));
      s.valid = (dot(n_g, s.wo) > 0.0f) && above;
    } else if (pick_clear) {
      float alpha_g = (1.0f - p.clearcoat_gloss) * 0.1f + p.clearcoat_gloss * 0.001f;
      alpha_g = regularize_alpha(alpha_g, reg);
      float a2 = alpha_g * alpha_g;
      float cos2 = (1.0f - powf(a2, 1.0f - r.b)) / (1.0f - a2);
      float cos_e = sqrtf(jclip(cos2, 0.0f, 1.0f));
      float sin_e = sqrtf(jclip(1.0f - cos2, 0.0f, 1.0f));
      float az = K_TWO_PI * r.c;
      V3 local_h = v3(sin_e * cosf(az), sin_e * sinf(az), cos_e);
      bool flip = dot(fw, dir_in) < 0.0f;
      V3 fu2 = flip ? -fu : fu, fv2 = flip ? -fv : fv, fw2 = flip ? -fw : fw;
      V3 h = normalize(onb_to_world(fu2, fv2, fw2, local_h));
      s.wo = mirror(dir_in, h);
      s.valid = (dot(n_g, s.wo) > 0.0f) && above;
    } else if (pick_metal || glass_as_metal) {
      // the reference metal sampler uses unclamped roughness^2
      float ax, ay;
      anisotropic_alphas(p.roughness, p.anisotropic, false, ax, ay);
      ax = regularize_alpha(ax, reg);
      ay = regularize_alpha(ay, reg);
      V3 lh = sample_vndf(world_to_onb(fu, fv, fw, dir_in), ax, ay, r.b, r.c);
      V3 h = normalize(onb_to_world(fu, fv, fw, lh));
      s.wo = mirror(dir_in, h);
      s.valid = pick_metal && (dot(s.wo, n_g) > 0.0f) && above;
    } else {
      // rough glass (disney.sample_rough_glass)
      float eta = in_geo >= 0.0f ? p.eta : 1.0f / p.eta;
      float ax, ay;
      anisotropic_alphas(p.roughness, p.anisotropic, true, ax, ay);
      ax = regularize_alpha(ax, reg);
      ay = regularize_alpha(ay, reg);
      V3 lh = sample_vndf(world_to_onb(fu, fv, fw, dir_in), ax, ay, r.b, r.c);
      V3 h = onb_to_world(fu, fv, fw, lh);
      float h_dot_in = dot(h, dir_in);
      float F = fresnel_dielectric(h_dot_in, eta);
      if (r.d <= F) {
        s.wo = mirror(dir_in, h);
        s.valid = (dot(s.wo, n_g) * in_geo) > 0.0f;
        s.eta = 0.0f;
      } else {
        float h_dot_out_sq = 1.0f - (1.0f - h_dot_in * h_dot_in) / (eta * eta);
        V3 h_flip = h_dot_in < 0.0f ? -h : h;
        float h_dot_out = sqrtf(jmax(h_dot_out_sq, 0.0f));
        V3 refr = -dir_in / eta + (fabsf(h_dot_in) / eta - h_dot_out) * h_flip;
        bool ok = (h_dot_out_sq > 0.0f) && ((dot(refr, n_g) * in_geo) < 0.0f);
        V3 gen_h = normalize(dir_in + refr * eta);
        float gh = dot(gen_h, dir_in);
        ok = ok && ((1.0f - (1.0f - gh * gh) / (eta * eta)) > 0.0f);
        s.wo = refr;
        s.valid = ok;
        s.eta = eta;
      }
    }
    if (!pick_glass) s.eta = 0.0f;
    s.is_spec = !pick_diff;
  }
  s.wo = normalize(s.wo);
  return s;
}

// bsdf.eval_pdf: (f, pdf); delta and emissive materials give (0, 0)
__device__ void eval_pdf(const Mat& p, int flags, V3 wi, V3 wo,
                         const HitInfo& hi, bool reg, V3& f, float& pdf) {
  f = v3(0.0f, 0.0f, 0.0f);
  pdf = 0.0f;
  if (p.type == MAT_LAMBERTIAN) {
    float cospi = jmax(dot(wo, hi.ns), 0.0f) * K_INV_PI;
    f = p.base * cospi;
    pdf = cospi;
  } else if (p.type == MAT_PRINCIPLED) {
    principled_eval_pdf(p, flags, wi, wo, hi, reg, f, pdf);
  }
}

// bsdf.eval_div_pdf (material integrator)
__device__ V3 eval_div_pdf(const Mat& p, int flags, V3 wi, V3 wo,
                           const HitInfo& hi, bool reg) {
  if (p.type == MAT_LAMBERTIAN) return p.base;
  if (p.type == MAT_DIELECTRIC) return v3(1.0f, 1.0f, 1.0f);
  if (p.type == MAT_PRINCIPLED) {
    V3 ev;
    float pp;
    principled_eval_pdf(p, flags, wi, wo, hi, reg, ev, pp);
    return pp > 0.0f ? ev / jmax(pp, 1e-20f) : v3(0.0f, 0.0f, 0.0f);
  }
  return v3(0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ V3 emitted(const Mat& p, V3 ray_dir, V3 n_s) {
  bool on = p.type == MAT_DIFFUSE_LIGHT && dot(n_s, ray_dir) < 0.0f;
  return on ? p.base : v3(0.0f, 0.0f, 0.0f);
}

// ---------------------------------------------------------------------------
// camera: integrators._primary_rays + camera.generate_rays. img_h/img_w and
// the R2 constants come precomputed from the host (kernel.py::_cam_table).
// ---------------------------------------------------------------------------

__device__ void primary_ray(const Tables& S, int pix, uint32_t samp, V3& ro,
                            V3& rd) {
  const float* c = S.cam;
  int x = pix % S.W;
  int y = (S.H - 1) - pix / S.W;
  float nf = (float)(x + y + (int)samp);
  float rx = c[20] * nf, ry = c[21] * nf;
  float px = (float)x + (rx - floorf(rx));
  float py = (float)y + (ry - floorf(ry));
  float img_h = c[3], img_w = c[4];
  // the camera's own width/height (c[22], c[23]) scale the image plane
  float x_dir = img_w * (px / c[22]) - img_w / 2.0f;
  float y_dir = img_h * (py / c[23]) - img_h / 2.0f;
  V3 d = normalize(v3(x_dir, y_dir, -1.0f));
  V3 o = v3(0.0f, 0.0f, 0.0f);
  if (S.flags & F_DOF) {
    U4 l = uniform4((uint32_t)pix, samp, 0u, DRAW_CAMERA_LENS);
    float r = sqrtf(l.a);
    float phi = K_TWO_PI * l.b;
    o = v3(r * cosf(phi) * c[1], r * sinf(phi) * c[1], 0.0f);
    float ft = c[2] / fabsf(d.z);
    d = normalize(d * ft - o);
  }
  const float* m = c + 5;
  ro = v3(m[0] * o.x + m[1] * o.y + m[2] * o.z + c[14],
          m[3] * o.x + m[4] * o.y + m[5] * o.z + c[15],
          m[6] * o.x + m[7] * o.y + m[8] * o.z + c[16]);
  rd = normalize(v3(m[0] * d.x + m[1] * d.y + m[2] * d.z,
                    m[3] * d.x + m[4] * d.y + m[5] * d.z,
                    m[6] * d.x + m[7] * d.y + m[8] * d.z));
}

__device__ __forceinline__ float balance(float a, float b) {
  return a / jmax(a + b, 1e-20f);
}

// integrators._roulette: returns survive; tp is reweighted on survival
__device__ __forceinline__ bool roulette(V3& tp, float eta_scale, float rnd) {
  float m = jmax(jmax(tp.x / eta_scale, tp.y / eta_scale), tp.z / eta_scale);
  float max_val = jmin(m, ROULETTE_CLAMP);
  bool survive = rnd <= max_val;
  if (survive) tp = tp / jmax(max_val, 1e-20f);
  return survive;
}

__device__ __forceinline__ V3 scrub_nan(V3 a) {
  return v3(isnanf_(a.x) ? 0.0f : a.x, isnanf_(a.y) ? 0.0f : a.y,
            isnanf_(a.z) ? 0.0f : a.z);
}

__device__ __forceinline__ float scrub_naninf(float a) {
  return (isnanf_(a) || isinf(a)) ? 0.0f : a;
}

// Per-thread counters: closest-hit segments and shadow rays (both modes),
// warp steps (analytic mode, kept by lane 0 of each warp), walk box and
// triangle tests and the walk's warp steps (mesh mode; steps by lane 0)
struct Counts {
  unsigned long long seg, shadow, steps;
  cwalk::Tests walk;
  cwalk::Steps wsteps;
};

// ---------------------------------------------------------------------------
// the path loop: one closest-hit segment per lane per iteration
// ---------------------------------------------------------------------------

// Per-lane state between iterations. A path in flight holds the ray its
// next segment traces (a bounce: ro is the last hit point, rd the sampled
// direction) and what that segment's MIS weights need (pdf2, w_one); the
// hit's shading data (HitInfo, Mat) lives only inside an iteration.
struct Lane {
  V3 ro, rd;
  V3 tp, result;    // the path's throughput and radiance so far
  V3 acc;           // the pixel's sum of its finished samples, in order
  float eta_scale, pdf2;
  int m, d;         // sample index (spp: the lane is done), depth
  bool fresh;       // the next segment is sample m's camera ray
  bool non_spec, w_one;
};

// A path ended with radiance res: add it to the pixel, start sample m + 1
__device__ __forceinline__ void end_path(Lane& L, V3 res) {
  L.acc = L.acc + res;
  L.m += 1;
  L.fresh = true;
}

// The steps below take `work`: whether this lane traces a segment. In
// mesh mode (G::kWarpWalk) every lane of the warp calls them, so that each
// trace is reached by the whole warp; in analytic mode only working lanes
// call them, with work = true.

// The closest hit of an MIS segment decided (integrators.mis_integrator_
// loop up to the hit's shading): the two early exits of a fresh path
// (background, an emissive first hit), a bounce's weighted emitter or
// background hit, roulette with key d before d advances, the depth limit.
// Returns whether the path goes on to shade its hit at depth L.d (then hi
// and mat hold its shading data).
template <class G>
__device__ __forceinline__ bool mis_hit(const Tables& S, int pix,
                                        uint32_t samp, float nl, const Hit& h,
                                        Lane& L, HitInfo& hi, Mat& mat) {
  if (h.id < 0) {
    V3 bg = ld3(S.cam + 17);
    if (L.fresh) {
      end_path(L, bg);
      return false;
    }
    if (S.flags & F_BG_EMISSIVE) {
      float w_bg = L.w_one ? 1.0f : balance(L.pdf2, K_INV_4PI / nl);
      L.result = L.result + L.tp * w_bg * bg;
    }
    end_path(L, L.result);
    return false;
  }
  hi = G::info(S, L.ro, L.rd, h);
  mat = load_mat(S, hi.mat);
  if (mat.type == MAT_DIFFUSE_LIGHT) {
    V3 em = emitted(mat, L.rd, hi.ns);
    if (L.fresh) {
      end_path(L, em);
      return false;
    }
    float light_pdf = surf_pdf(S, h.id, L.ro, hi.p, L.rd) / nl;
    V3 gd = L.ro - hi.p;
    float dist2 = jmax(dot(gd, gd), 1e-20f);
    float G2 = fabsf(dot(hi.ng, normalize(gd))) / dist2;
    // pdf2*G2 can overflow to inf; the clamp keeps the weight -> 1
    float w_hit = L.w_one ? 1.0f : balance(jmin(L.pdf2 * G2, 1e30f), light_pdf);
    L.result = L.result + L.tp * w_hit * em;
    end_path(L, L.result);
    return false;
  }
  if (L.fresh) {
    L.result = v3(0.0f, 0.0f, 0.0f);
    L.tp = v3(1.0f, 1.0f, 1.0f);
    L.non_spec = false;
    L.eta_scale = 1.0f;
    L.d = 0;
    L.fresh = false;
  } else {
    // russian roulette after the bounce hit a non-light surface
    if (L.d > ROULETTE_THRESHOLD) {
      U4 rr = uniform4((uint32_t)pix, samp, (uint32_t)L.d, DRAW_ROULETTE);
      if (!roulette(L.tp, L.eta_scale, rr.a)) {
        end_path(L, L.result);
        return false;
      }
    }
    L.d += 1;
  }
  if (L.d >= S.max_depth) {
    end_path(L, L.result);
    return false;
  }
  return true;
}

// The light sample's MIS-weighted contribution, its shadow ray unoccluded
__device__ __forceinline__ void nee_add(const Tables& S, Lane& L,
                                        const HitInfo& hi, const Mat& mat,
                                        const LightSample& ls) {
  V3 f;
  float mpdf;
  eval_pdf(mat, S.flags, L.rd, ls.wi, hi, L.non_spec, f, mpdf);
  if (mpdf != 0.0f && !isnanf_(mpdf)) {
    float w = balance(ls.pdf, mpdf * ls.G);
    V3 contrib = L.tp * f * ls.rad * (w * ls.G / jmax(ls.pdf, 1e-20f));
    L.result = L.result + scrub_nan(contrib);
  }
}

// BSDF sampling at the hit of an MIS segment: the next ray, or the end
__device__ __forceinline__ void mis_scatter(const Tables& S, int pix,
                                            uint32_t samp, Lane& L,
                                            const HitInfo& hi, const Mat& mat) {
  const bool mat_delta = mat.type == MAT_DIELECTRIC;
  U4 b = uniform4((uint32_t)pix, samp, (uint32_t)L.d, DRAW_BSDF_SAMPLE);
  Scatter sc = sample_mat(mat, S.flags, L.rd, hi, b, L.non_spec);
  bool cont = sc.valid;
  L.non_spec = L.non_spec || (cont && !sc.is_spec);
  if (sc.eta != 0.0f) L.eta_scale = L.eta_scale / (sc.eta * sc.eta);
  V3 f2;
  float pdf2;
  eval_pdf(mat, S.flags, L.rd, sc.wo, hi, L.non_spec, f2, pdf2);
  cont = cont && !isnanf_(pdf2);
  if (!cont) {
    end_path(L, L.result);
    return;
  }
  V3 ratio;
  if (mat_delta) {
    ratio = v3(1.0f, 1.0f, 1.0f);
  } else {
    float den = jmax(pdf2, 1e-20f);
    ratio = v3(scrub_naninf(f2.x / den), scrub_naninf(f2.y / den),
               scrub_naninf(f2.z / den));
  }
  L.tp = L.tp * ratio;
  L.pdf2 = pdf2;
  L.w_one = mat_delta || pdf2 == 0.0f;
  L.ro = hi.p;
  L.rd = sc.wo;
}

// One segment of an MIS path (integrators.mis_integrator_loop, cut at its
// closest-hit traces). A fresh path traces its camera ray; mis_hit decides
// the hit; a path that goes on then shades its new hit at depth d (NEE
// shadow ray, BSDF sample) and keeps the next ray.
template <class G>
__device__ __forceinline__ void mis_step(const Tables& S, int pix, Lane& L,
                                         Counts& c, bool work) {
  const float inf = __int_as_float(0x7f800000);
  const uint32_t samp = (uint32_t)(L.m + S.sample_offset);
  const float nl = (float)(S.nl > 1 ? S.nl : 1);
  if (work && L.fresh) primary_ray(S, pix, samp, L.ro, L.rd);
  if (work) c.seg += 1;
  Hit h = G::closest(S, L.ro, L.rd, MIN_T, inf, work, c.walk, c.wsteps);
  HitInfo hi;
  Mat mat;
  const bool go = work && mis_hit<G>(S, pix, samp, nl, h, L, hi, mat);
  if (!G::kWarpWalk && !go) return;
  // ---- shade the hit at depth d: light sampling (NEE) ----
  LightSample ls;
  bool shadow = false;
  V3 sro = L.ro, swi = L.rd;  // a lane without a shadow ray passes these
  float shadow_max = inf;
  if (go && S.nl > 0) {
    U4 l = uniform4((uint32_t)pix, samp, (uint32_t)L.d, DRAW_LIGHT_SAMPLE);
    ls = sample_lights(S, hi.p, l.a, l.b, l.c);
    if (mat.type != MAT_DIELECTRIC && ls.pdf != 0.0f) {
      c.shadow += 1;
      shadow_max = isfinite(ls.dist) ? ls.dist - SHADOW_EPS : inf;
      if constexpr (G::kWarpWalk) {
        shadow = true;
        sro = hi.p;
        swi = ls.wi;
      } else if (!G::occluded(S, hi.p, ls.wi, MIN_T, shadow_max, true,
                              c.walk, c.wsteps)) {
        nee_add(S, L, hi, mat, ls);
      }
    }
  }
  if constexpr (G::kWarpWalk) {
    // the whole warp traces, lanes without a shadow ray too
    const bool occ = G::occluded(S, sro, swi, MIN_T, shadow_max, shadow,
                                 c.walk, c.wsteps);
    if (shadow && !occ) nee_add(S, L, hi, mat, ls);
  }
  // ---- BSDF sampling ----
  if (go) mis_scatter(S, pix, samp, L, hi, mat);
}

// The hit of a material-integrator segment shaded: emission, BSDF sample,
// roulette, depth (the rest of one iteration of
// integrators.material_integrator_loop)
template <class G>
__device__ __forceinline__ void material_hit(const Tables& S, int pix,
                                             uint32_t samp, const Hit& h,
                                             Lane& L) {
  if (h.id < 0) {
    L.result = L.result + L.tp * ld3(S.cam + 17);
    end_path(L, L.result);
    return;
  }
  HitInfo hi = G::info(S, L.ro, L.rd, h);
  Mat mat = load_mat(S, hi.mat);
  V3 em = emitted(mat, L.rd, hi.ns);
  U4 b = uniform4((uint32_t)pix, samp, (uint32_t)L.d, DRAW_BSDF_SAMPLE);
  Scatter sc = sample_mat(mat, S.flags, L.rd, hi, b, L.non_spec);
  if (!sc.valid) {
    L.result = L.result + L.tp * em;
    end_path(L, L.result);
    return;
  }
  L.non_spec = L.non_spec || !sc.is_spec;
  if (sc.eta != 0.0f) L.eta_scale = L.eta_scale / (sc.eta * sc.eta);
  V3 ratio = eval_div_pdf(mat, S.flags, L.rd, sc.wo, hi, L.non_spec);
  L.tp = L.tp * (em + ratio);
  if (L.d > ROULETTE_THRESHOLD) {
    U4 rr = uniform4((uint32_t)pix, samp, (uint32_t)L.d, DRAW_ROULETTE);
    if (!roulette(L.tp, L.eta_scale, rr.a)) {
      end_path(L, L.result);
      return;
    }
  }
  L.ro = hi.p;
  L.rd = sc.wo;
  L.d += 1;
  if (L.d >= S.max_depth) end_path(L, L.result);
}

// One segment of a material-integrator path: one iteration of
// integrators.material_integrator_loop
template <class G>
__device__ __forceinline__ void material_step(const Tables& S, int pix,
                                              Lane& L, Counts& c, bool work) {
  const float inf = __int_as_float(0x7f800000);
  const uint32_t samp = (uint32_t)(L.m + S.sample_offset);
  if (work && L.fresh) {
    primary_ray(S, pix, samp, L.ro, L.rd);
    L.result = v3(0.0f, 0.0f, 0.0f);
    L.tp = v3(1.0f, 1.0f, 1.0f);
    L.non_spec = false;
    L.eta_scale = 1.0f;
    L.d = 0;
    L.fresh = false;
  }
  if (work) c.seg += 1;
  Hit h = G::closest(S, L.ro, L.rd, MIN_T, inf, work, c.walk, c.wsteps);
  if (work) material_hit<G>(S, pix, samp, h, L);
}

// ---------------------------------------------------------------------------
// kernel + C entry
// ---------------------------------------------------------------------------

#define BLOCK 128
static_assert(BLOCK == 32 * cwalk::WALK_WARPS, "the mesh walk's scratch");
#define WARPS (BLOCK / 32)
#define FULL_MASK 0xffffffffu

// Pixel groups: a warp shades one group of 32 pixels at a time, lane i
// one pixel, and takes its next group when every lane is done.
// - analytic mode: 32 consecutive pixels;
// - mesh mode: an 8 x 4 tile, so that the rays of a warp start close
//   together and walk similar nodes (the TPU kernel's TILE_W pixel tiles
//   serve the same end).
#define GROUP_W 8
#define GROUP_H 4

template <class G>
__host__ __device__ __forceinline__ int n_groups(const Tables& S) {
  if constexpr (!G::kTiled) return (S.W * S.H + 31) / 32;
  return ((S.W + GROUP_W - 1) / GROUP_W) * ((S.H + GROUP_H - 1) / GROUP_H);
}

// The pixel of this lane in group g, or -1 outside the image
template <class G>
__device__ __forceinline__ int group_pixel(const Tables& S, int g, int lane) {
  if constexpr (!G::kTiled) {
    int pix = g * 32 + lane;
    return pix < S.W * S.H ? pix : -1;
  }
  int groups_x = (S.W + GROUP_W - 1) / GROUP_W;
  int x = (g % groups_x) * GROUP_W + (lane % GROUP_W);
  int row = (g / groups_x) * GROUP_H + lane / GROUP_W;
  return (x < S.W && row < S.H) ? row * S.W + x : -1;
}

// Persistent warps: the launch holds as many blocks as are resident on the
// card at once; each warp takes pixel groups from the global counter
// next_group (preset by the caller to group_begin), one atomic per group,
// until it reaches group_end. The film's pixels outside those groups are
// not written. (The end is tested beside the frame's group count, and the
// begin rides in the counter: reading either into the loop otherwise made
// the analytic kernel's code about 2% slower.) Within a group each lane runs its pixel's spp paths in sample
// order, one segment an iteration. With the flat loop (G::kFlat) a lane
// whose path ends adds it to the pixel's sum and starts its next sample at
// the next iteration, so the warp runs max over lanes of (the lane's
// segments) iterations for the group. Otherwise (the per-sample loop) it
// waits until every lane has ended the same sample, and the warp runs the
// sum over samples of the sample's longest path. Either way each pixel's
// film value is its samples' sum in sample order, whoever shades the
// group. The analytic kernel adds each group's iterations to stats[2]
// (warp steps).
template <class G, bool kMis>
__global__ void __launch_bounds__(BLOCK, G::kMinBlocks)
mega_kernel(Tables S, float* __restrict__ film,
            unsigned long long* __restrict__ stats,
            unsigned int* __restrict__ next_group) {
  constexpr int NS = G::kStats;
  __shared__ unsigned long long s_stats[NS];
  if (threadIdx.x < NS) s_stats[threadIdx.x] = 0ull;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int groups = n_groups<G>(S);
  Counts c;
  c.seg = 0ull;
  c.shadow = 0ull;
  c.steps = 0ull;
  c.walk.box = 0u;
  c.walk.tri = 0u;
  c.wsteps.node = 0u;
  c.wsteps.tri = 0u;
  for (;;) {
    int g = 0;
    if (lane == 0) g = (int)atomicAdd(next_group, 1u);
    g = __shfl_sync(FULL_MASK, g, 0);
    if (g >= groups || g >= S.group_end) break;
    const int pix = group_pixel<G>(S, g, lane);
    Lane L;
    L.acc = v3(0.0f, 0.0f, 0.0f);
    L.fresh = true;
    // a material path of max_depth <= 0 traces nothing and adds +0
    L.m = (pix < 0 || (!kMis && S.max_depth <= 0)) ? S.spp : 0;
    for (;;) {
      bool work = L.m < S.spp;
      if (!__any_sync(FULL_MASK, work)) break;
      if constexpr (!G::kFlat) {
        bool between = __all_sync(FULL_MASK, L.fresh || !work);
        work = work && (between || !L.fresh);
      }
      if (G::kWarpWalk || work) {
        if (kMis)
          mis_step<G>(S, pix, L, c, work);
        else
          material_step<G>(S, pix, L, c, work);
      }
      if (lane == 0) c.steps += 1;
    }
    if (pix >= 0) {
      film[3 * pix + 0] = L.acc.x;
      film[3 * pix + 1] = L.acc.y;
      film[3 * pix + 2] = L.acc.z;
    }
  }
  // per-block counter reduction: warp shuffle, shared atomics, one global
  // atomic per counter per block
  unsigned long long v[NS];
  v[0] = c.seg;
  v[1] = c.shadow;
  if constexpr (NS == 3) v[2] = c.steps;
  if constexpr (NS == 6) {
    v[2] = c.walk.box;
    v[3] = c.walk.tri;
    v[4] = c.wsteps.node;
    v[5] = c.wsteps.tri;
  }
#pragma unroll
  for (int k = 0; k < NS; ++k)
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(FULL_MASK, v[k], off);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NS; ++k) atomicAdd(&s_stats[k], v[k]);
  }
  __syncthreads();
  if (threadIdx.x < NS) atomicAdd(&stats[threadIdx.x], s_stats[threadIdx.x]);
}

// The kernel of a mode and integrator
template <class G>
static const void* kernel_of(bool mis) {
  return mis ? (const void*)mega_kernel<G, true>
             : (const void*)mega_kernel<G, false>;
}

// Launch the kernel of mode G on `blocks` blocks, or (blocks <= 0) on as
// many as are resident on the card at once, never more than the groups
// need; returns cudaGetLastError().
template <class G>
static int launch(const Tables& S, int blocks, float* film,
                  unsigned long long* stats, unsigned int* next_group,
                  cudaStream_t stream) {
  const void* fn = kernel_of<G>((S.flags & F_MIS) != 0);
  if (blocks <= 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, BLOCK, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  int need = (S.group_end - S.group_begin + WARPS - 1) / WARPS;
  blocks = blocks < need ? blocks : need;
  if (blocks < 1) blocks = 1;
  void* args[] = {(void*)&S, (void*)&film, (void*)&stats, (void*)&next_group};
  cudaLaunchKernel(fn, dim3(blocks), dim3(BLOCK), args, 0, stream);
  return (int)cudaGetLastError();
}

// B1: analytic scenes (<= 64 triangles without vertex normals). The launch
// shades pixel groups [group_begin, group_end) (0 and n_groups: the whole
// frame); blocks <= 0 launches the resident grid; next_group is one counter
// holding group_begin; stats gets segments, shadow rays, warp steps.
extern "C" int vimg_mega_render(
    const float* tri_c, const float* tri_v, const float* sph,
    const int* prim_mat, const int* mat_type, const float* mat_base,
    const float* mat_sc, const float* light_rows, const int* light_type,
    const float* cam, int nt, int ns, int nl, int W, int H, int spp,
    int max_depth, int sample_offset, int flags, int group_begin,
    int group_end, int blocks, float* film, unsigned long long* stats,
    unsigned int* next_group, void* stream) {
  Tables S = {};
  S.tri_c = tri_c;
  S.tri_v = tri_v;
  S.sph = sph;
  S.prim_mat = prim_mat;
  S.mat_type = mat_type;
  S.mat_base = mat_base;
  S.mat_sc = mat_sc;
  S.light_rows = light_rows;
  S.light_type = light_type;
  S.cam = cam;
  S.nt = nt;
  S.ns = ns;
  S.nl = nl;
  S.W = W;
  S.H = H;
  S.spp = spp;
  S.max_depth = max_depth;
  S.sample_offset = sample_offset;
  S.flags = flags;
  S.group_begin = group_begin;
  S.group_end = group_end;
  return launch<Analytic>(S, blocks, film, stats, next_group,
                          (cudaStream_t)stream);
}

// B2: mesh scenes (more than 64 triangles, or vertex normals), launched as
// B1; stats gets segments, shadow rays, box tests, triangle tests, the
// walk's warp node steps and warp triangle steps
extern "C" int vimg_mega_render_mesh(
    const float* tri_v, const float* sph, const int* prim_mat,
    const int* mat_type, const float* mat_base, const float* mat_sc,
    const float* light_rows, const int* light_type, const float* cam,
    const float* node_aabb, const int* node_cid, const int* node_skip,
    const float* ctri, const int* perm, const float* vnormals,
    const int* tri_vidx, const int* tri_flags, int nt, int ns, int nl,
    int n_nodes, int W, int H, int spp, int max_depth, int sample_offset,
    int flags, int group_begin, int group_end, int blocks, float* film,
    unsigned long long* stats, unsigned int* next_group, void* stream) {
  Tables S = {};
  S.tri_v = tri_v;
  S.sph = sph;
  S.prim_mat = prim_mat;
  S.mat_type = mat_type;
  S.mat_base = mat_base;
  S.mat_sc = mat_sc;
  S.light_rows = light_rows;
  S.light_type = light_type;
  S.cam = cam;
  S.node_aabb = node_aabb;
  S.node_cid = node_cid;
  S.node_skip = node_skip;
  S.ctri = ctri;
  S.perm = perm;
  S.vnormals = vnormals;
  S.tri_vidx = tri_vidx;
  S.tri_flags = tri_flags;
  S.nt = nt;
  S.ns = ns;
  S.nl = nl;
  S.n_nodes = n_nodes;
  S.W = W;
  S.H = H;
  S.spp = spp;
  S.max_depth = max_depth;
  S.sample_offset = sample_offset;
  S.flags = flags;
  S.group_begin = group_begin;
  S.group_end = group_end;
  return launch<Mesh>(S, blocks, film, stats, next_group,
                      (cudaStream_t)stream);
}

// What a launch of the mode (mesh 0: B1, 1: B2) and integrator would run:
// its resident blocks per SM (blocks of BLOCK threads), registers a thread
// and local memory bytes a thread (its stack frame, spills included).
extern "C" int vimg_mega_occupancy(int mesh, int mis, int* per_sm, int* regs,
                                   int* local_bytes) {
  const void* fn = mesh ? kernel_of<Mesh>(mis != 0)
                        : kernel_of<Analytic>(mis != 0);
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, fn);
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, BLOCK, 0);
  return (int)cudaGetLastError();
}

// The error text of a launcher's return code, for every kernel of the
// library (vimg_tpu_torch/runtime/cuda.py::check).
extern "C" const char* vimg_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
