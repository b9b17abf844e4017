// Packet-kernel build-up probe for Hopper (sm_90a): kernel P11 of
// vimg_tpu_torch's probes (probes/probe_r4c.py).
//
// Replaces: tools/probe_r4c.py::make_kernel (pallas_call in run_stage
// :158). Per workgroup (an (8, 128) block of xt and of meta, the triangle
// table whole), the packet kernel is built up in stages:
//   0  setup: lane column c * 16 + p of xt is ray component c (ox oy oz dx
//      dy dz minT maxT) of the 8 rays of packet p; output sum over p of
//      (ox + maxT) per row, on every lane
//   1  + the chain loop: per entry i < count (meta row 2, lane 0) the 12
//      constant rows of cluster meta[0, i], summed, plus the packet mask
//      meta[1, i]
//   2  + one unconditional triangle test of packet 0 per entry: (bt, code)
//      per (ray, lane), output bt + code
//   3  + the test gated by bit 0 of the packet mask
//   4  n_packets packets, each gated by its bit; per packet the minimum bt
//      over the lanes into lane p and the least code at it into lane 16 + p
//
// Design: one block of 128 threads per workgroup. The setup extracts the
// lane columns into shared memory (the TPU's ray scratch). Stages 0-3 give
// thread k lane k, as the TPU's vector ops do (8 rays in registers, the
// cluster's constants for lane k loaded by index). Stage 4 gives thread
// 8 p + r the ray r of packet p: per entry the block stages the cluster's
// 12 x 128 constants in shared memory and each ray of a live packet loops
// over the 128 lanes there. The TPU keeps (bt, code) per (ray, lane) and
// reduces at the end; a thread keeps the lanes' minimum bt, its code and a
// 128-bit mask of the lanes at it, kernel B5's rule (csrc/packet_trace.cu):
// t < bt restarts them; t == bt on a lane not yet in the mask (once a hit
// is recorded) joins it with the lesser code. That equals the per-lane rule
// for any chain order. Cluster ids are clamped into the table and count
// into [0, 128], as the plain version clamps them. The triangle test is
// the probe's (and B5's) arithmetic; the file is built with -fmad=false
// and without fast math.
//
// What bounds it on this card: launch latency and the serial chain (40
// entries of 128 lanes per workgroup, 8 workgroups: a few microseconds).
//
// Launch contract: vimg_probe_packet_stage() launches on the given stream,
// does not synchronise and allocates nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;     // = CP, the chain entries per meta row
constexpr int ROWS = 8;        // rays per packet
constexpr int MAX_PACKETS = 16;
constexpr int N_CONST = 12;

struct Tri {
  float nx, ny, nz, d0, m1x, m1y, m1z, c1, m2x, m2y, m2z, c2;
};

// the probe's triangle test; returns whether it hits below bt
__device__ __forceinline__ bool test(const Tri& q, float ox, float oy,
                                     float oz, float dx, float dy, float dz,
                                     float mnt, float bt, float& t_out) {
  const float ro_n = ox * q.nx + oy * q.ny + oz * q.nz;
  const float rd_n = dx * q.nx + dy * q.ny + dz * q.nz;
  const bool par = fabsf(rd_n) < 1e-22f;
  const float t = (q.d0 - ro_n) / (par ? 1.0f : rd_n);
  const float u = ox * q.m1x + oy * q.m1y + oz * q.m1z - q.c1
                  + t * (dx * q.m1x + dy * q.m1y + dz * q.m1z);
  const float v = ox * q.m2x + oy * q.m2y + oz * q.m2z - q.c2
                  + t * (dx * q.m2x + dy * q.m2y + dz * q.m2z);
  t_out = t;
  return !par && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= mnt &&
         t < bt;
}

__device__ __forceinline__ Tri load_tri(const float* __restrict__ tri, int c,
                                        int k) {
  const float* q = tri + (size_t)c * N_CONST * LANES + k;
  Tri t;
  t.nx = q[0];
  t.ny = q[LANES];
  t.nz = q[2 * LANES];
  t.d0 = q[3 * LANES];
  t.m1x = q[4 * LANES];
  t.m1y = q[5 * LANES];
  t.m1z = q[6 * LANES];
  t.c1 = q[7 * LANES];
  t.m2x = q[8 * LANES];
  t.m2y = q[9 * LANES];
  t.m2z = q[10 * LANES];
  t.c2 = q[11 * LANES];
  return t;
}

__global__ void __launch_bounds__(LANES)
    stage_kernel(const float* __restrict__ xt, const int* __restrict__ meta,
                 const float* __restrict__ tri, int n_clusters, int stage,
                 int n_packets, float* __restrict__ out) {
  __shared__ float s_ray[MAX_PACKETS][8][ROWS];   // (p, component, ray)
  __shared__ float s_tri[N_CONST][LANES];
  const int tid = threadIdx.x;
  const int w = blockIdx.x;
  const float* x = xt + (size_t)w * ROWS * LANES;
  const int* m = meta + (size_t)w * ROWS * LANES;
  float* o = out + (size_t)w * ROWS * LANES;
  for (int e = tid; e < n_packets * 8 * ROWS; e += LANES) {
    const int p = e / (8 * ROWS), c = (e / ROWS) % 8, r = e % ROWS;
    s_ray[p][c][r] = x[r * LANES + c * 16 + p];
  }
  __syncthreads();
  const int count = min(max(m[2 * LANES], 0), LANES);
  auto cluster = [&](int i) { return min(max(m[i], 0), n_clusters - 1); };

  if (stage == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; r++) {
      float acc = 0.0f;
      for (int p = 0; p < n_packets; p++)
        acc = acc + s_ray[p][0][r] + s_ray[p][7][r];
      o[r * LANES + tid] = acc;
    }
    return;
  }
  if (stage == 1) {
    float acc = 0.0f;
    for (int i = 0; i < count; i++) {
      const float* q = tri + (size_t)cluster(i) * N_CONST * LANES + tid;
      float s = q[0];
#pragma unroll
      for (int j = 1; j < N_CONST; j++) s = s + q[j * LANES];
      acc = acc + s * 1.0f + (float)m[LANES + i];
    }
#pragma unroll
    for (int r = 0; r < ROWS; r++) o[r * LANES + tid] = acc;
    return;
  }
  if (stage == 2 || stage == 3) {
    float bt[ROWS], code[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; r++) {
      bt[r] = s_ray[0][7][r];
      code[r] = -1.0f;
    }
    for (int i = 0; i < count; i++) {
      if (stage == 3 && !((unsigned)m[LANES + i] & 1u)) continue;
      const int c = cluster(i);
      const Tri q = load_tri(tri, c, tid);
      const float cbase = (float)(c * LANES);
#pragma unroll
      for (int r = 0; r < ROWS; r++) {
        float t;
        if (test(q, s_ray[0][0][r], s_ray[0][1][r], s_ray[0][2][r],
                 s_ray[0][3][r], s_ray[0][4][r], s_ray[0][5][r],
                 s_ray[0][6][r], bt[r], t)) {
          bt[r] = t;
          code[r] = cbase + (float)tid;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; r++) o[r * LANES + tid] = bt[r] + code[r];
    return;
  }

  // stage 4: thread 8 p + r owns ray r of packet p
  const int p = tid / ROWS, r = tid % ROWS;
  const bool mine = p < n_packets;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float mnt = 0.0f, bt = 0.0f;
  if (mine) {
    ox = s_ray[p][0][r];
    oy = s_ray[p][1][r];
    oz = s_ray[p][2][r];
    dx = s_ray[p][3][r];
    dy = s_ray[p][4][r];
    dz = s_ray[p][5][r];
    mnt = s_ray[p][6][r];
    bt = s_ray[p][7][r];
  }
  int code = -1;
  unsigned m0 = 0u, m1 = 0u, m2 = 0u, m3 = 0u;   // lanes at bt
  for (int i = 0; i < count; i++) {
    const int c = cluster(i);
    const unsigned pm = (unsigned)m[LANES + i];
    const float* src = tri + (size_t)c * N_CONST * LANES;
#pragma unroll
    for (int j = 0; j < N_CONST; j++) s_tri[j][tid] = src[j * LANES + tid];
    __syncthreads();
    if (mine && ((pm >> p) & 1u)) {
      const int cbase = c * LANES;
#pragma unroll
      for (int qd = 0; qd < 4; qd++) {
#pragma unroll 2
        for (int kk = 0; kk < 32; kk++) {
          const int k = qd * 32 + kk;
          Tri q;
          q.nx = s_tri[0][k];
          q.ny = s_tri[1][k];
          q.nz = s_tri[2][k];
          q.d0 = s_tri[3][k];
          q.m1x = s_tri[4][k];
          q.m1y = s_tri[5][k];
          q.m1z = s_tri[6][k];
          q.c1 = s_tri[7][k];
          q.m2x = s_tri[8][k];
          q.m2y = s_tri[9][k];
          q.m2z = s_tri[10][k];
          q.c2 = s_tri[11][k];
          float t;
          // the test's own t < bt is the per-lane rule's only when no lane
          // is below t; the restart and the join below decide the rest
          const bool hit = test(q, ox, oy, oz, dx, dy, dz, mnt, INFINITY, t);
          if (!hit) continue;
          const unsigned bitk = 1u << kk;
          if (t < bt) {
            bt = t;
            code = cbase + k;
            m0 = qd == 0 ? bitk : 0u;
            m1 = qd == 1 ? bitk : 0u;
            m2 = qd == 2 ? bitk : 0u;
            m3 = qd == 3 ? bitk : 0u;
          } else if (t == bt && code >= 0) {
            unsigned& mq = qd == 0 ? m0 : qd == 1 ? m1 : qd == 2 ? m2 : m3;
            if (!(mq & bitk)) {
              mq |= bitk;
              code = min(code, cbase + k);
            }
          }
        }
      }
    }
    __syncthreads();   // s_tri is rewritten by the next entry
  }
  // lanes p and 16 + p of row r (each added to the probe's zero tile, so
  // a -0 minimum turns +0 there too); lanes 32..127 stay 0
  o[r * LANES + p] = mine ? 0.0f + bt : 0.0f;
  o[r * LANES + 16 + p] = mine ? (float)code : 0.0f;
  for (int e = tid; e < ROWS * (LANES - 32); e += LANES)
    o[(e / (LANES - 32)) * LANES + 32 + e % (LANES - 32)] = 0.0f;
}

}  // namespace

// xt (n_work * 8, 128) float32, meta (n_work * 8, 128) int32, tri
// (n_clusters * 12, 128) float32, out (n_work * 8, 128) float32; stage 0-4,
// 1 <= n_packets <= 16.
extern "C" int vimg_probe_packet_stage(const float* xt, const int* meta,
                                       const float* tri, int n_work,
                                       int n_clusters, int stage,
                                       int n_packets, float* out,
                                       void* stream) {
  if (stage < 0 || stage > 4 || n_packets < 1 || n_packets > MAX_PACKETS ||
      n_clusters < 1)
    return (int)cudaErrorInvalidValue;
  stage_kernel<<<n_work, LANES, 0, (cudaStream_t)stream>>>(
      xt, meta, tri, n_clusters, stage, n_packets, out);
  return (int)cudaGetLastError();
}
