// Persistent-lane path-tracing kernel for Hopper (sm_90a).
//
// Replaces wavefront_path_tracer_tpu/ops/pallas_kernels.py:
// fused_render_persistent / make_persistent_tile(None) / _persistent_impl,
// with its inlined _raygen_tile, _intersect_tile, _shade_tile, the sky/miss
// accumulation, Russian roulette and the PCG helpers.  It computes the same
// function: every sample and every bounce of each lane in one launch, with
// the same per-(pixel, sample, bounce) RNG streams, the same nearest-hit
// rule and the same shading formulas.
//
// Design.  One thread owns one lane and loops over its own samples and
// bounces: on SIMT hardware the persistent-lane idea is native, since a
// thread whose path ends regenerates its pixel's next sample with no
// cross-lane work.  Lanes arrive in the 32x32 image-block order of
// models/fused.py:_block_perm, so a warp traces a coherent 32-pixel row of
// one block.  Padding lanes (valid == 0) do no work.  The TPU kernel's lane
// rotation only reorders a pixel's sample sum, so it is not carried.  Each
// thread writes its own three radiance words and one ray counter once: no
// atomics, and the result is deterministic.
//
// What bounds it on this card: FP32 issue.  The brute-force nearest hit
// costs about 25 flops per ray-sphere pair, and every ray tests all spheres
// of the table (486 for book_one_final), so the intersect loop is nearly all
// of the work.  The second cost is divergence across a warp at path ends:
// a warp runs as long as its longest path chain.  The design answers the
// first by keeping the intersect loop lean (one 16-byte load of centre and
// radius per sphere, the winner carried as an index, attributes fetched once
// after the loop) and leaves the table to L1/L2 (486 x 64 B = 31 KB); the
// second by giving each thread its own sample loop, so a thread whose path
// ends early starts its next sample instead of idling until the warp's
// longest path ends.  Shared-memory staging of the table, culling and
// tensor-core work are later steps.
//
// Numerics.  Build without --use_fast_math: the nearest-hit select relies on
// a NaN padding row failing the strict `t < best_t`, and division and sqrt
// stay IEEE (-prec-div=true -prec-sqrt=true, the defaults).  The guards
// before rsqrtf are kept as in the reference.  The RNG is bit-exact with
// ops/rng.py.  The build turns FMA contraction off (-fmad=false): then every
// float result is bit-identical to the plain PyTorch version on the card,
// which is how the kernel is checked.  With contraction, a few deep bounces
// pick another sphere and those paths diverge from the plain version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kTMin = 0.001f;
constexpr float kTFar = 1e30f;
constexpr uint32_t kPcgMult = 747796405u;
constexpr uint32_t kPcgInc = 2891336453u;
constexpr uint32_t kRxsM = 277803737u;
constexpr float kU32ToF32 = 2.3283064365387e-10f;
constexpr float kTwoPi = (float)(2.0 * 3.1415927);
constexpr uint32_t kSampleStride = 0x9E3779B9u;
constexpr uint32_t kBounceStride = 0x85EBCA6Bu;
constexpr uint32_t kRrSalt = 0x52455252u;
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t jenkins(uint32_t x) {
  x = x + (x << 10);
  x = x ^ (x >> 6);
  x = x + (x << 3);
  x = x ^ (x >> 11);
  x = x + (x << 15);
  return x;
}

__device__ __forceinline__ uint32_t pcg_next(uint32_t& state) {
  state = state * kPcgMult + kPcgInc;
  const uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * kRxsM;
  return (word >> 22) ^ word;
}

__device__ __forceinline__ float next_f32(uint32_t& state) {
  return __uint2float_rn(pcg_next(state)) * kU32ToF32;
}

struct Camera {
  float r[9];       // view rotation, row-major
  float pos[3];     // camera position
  float w_scale, h_scale, z_far, defocus_radius, focus_distance;
  float width, height;
};

// _raygen_tile (pallas_kernels.py:461): bounce slot 0 of the stream.
__device__ __forceinline__ void raygen(
    const Camera& cam, float xs, float ys, uint32_t base, uint32_t sample,
    bool stratified, float& ox, float& oy, float& oz,
    float& dx, float& dy, float& dz) {
  uint32_t st = jenkins(base + sample * kSampleStride);
  float u1 = next_f32(st);
  float u2 = next_f32(st);
  const float u3 = next_f32(st);
  const float u4 = next_f32(st);
  if (stratified) {
    const float sx = (float)(sample & 3u);
    const float sy = (float)((sample >> 2) & 3u);
    u1 = (sx + u1) * 0.25f;
    u2 = (sy + u2) * 0.25f;
  }
  const float r_aa = sqrtf(u1);
  const float a_aa = kTwoPi * u2;
  const float ox_j = r_aa * cosf(a_aa);
  const float oy_j = r_aa * sinf(a_aa);
  const float ndc_x = 2.0f * ((xs + ox_j) / cam.width) - 1.0f;
  const float ndc_y = 2.0f * (1.0f - (ys + oy_j) / cam.height) - 1.0f;
  const float zf = cam.z_far;
  float ppx = cam.w_scale * ndc_x * zf;
  float ppy = cam.h_scale * ndc_y * zf;
  float ppz = zf;
  const float r_l = sqrtf(u3);
  const float a_l = kTwoPi * u4;
  const float plx = cam.defocus_radius * (r_l * cosf(a_l));
  const float ply = cam.defocus_radius * (r_l * sinf(a_l));
  const float tf = cam.focus_distance / ppz;
  ppx = tf * ppx - plx;
  ppy = tf * ppy - ply;
  ppz = tf * ppz;
  ox = cam.r[0] * plx + cam.r[1] * ply + cam.pos[0];
  oy = cam.r[3] * plx + cam.r[4] * ply + cam.pos[1];
  oz = cam.r[6] * plx + cam.r[7] * ply + cam.pos[2];
  dx = cam.r[0] * ppx + cam.r[1] * ppy + cam.r[2] * ppz;
  dy = cam.r[3] * ppx + cam.r[4] * ppy + cam.r[5] * ppz;
  dz = cam.r[6] * ppx + cam.r[7] * ppy + cam.r[8] * ppz;
  const float inv = rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-37f));
  dx *= inv;
  dy *= inv;
  dz *= inv;
}

// _intersect_tile (pallas_kernels.py:106): nearest hit over the (S, 16)
// table in table order, strict `<`, so the first index wins ties and a NaN
// padding row (every compare false) never wins.  Returns the winner's row
// or -1.
__device__ __forceinline__ int intersect(
    const float4* __restrict__ rows, int n_rows,
    float ox, float oy, float oz, float dx, float dy, float dz,
    float& best_t) {
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;
  int best = -1;
  best_t = kTFar;
#pragma unroll 4
  for (int i = 0; i < n_rows; ++i) {
    const float4 s = __ldg(rows + 4 * i);   // centre xyz, radius
    const float ocx = ox - s.x;
    const float ocy = oy - s.y;
    const float ocz = oz - s.z;
    const float b = dx * ocx + dy * ocy + dz * ocz;
    const float c = ocx * ocx + ocy * ocy + ocz * ocz - s.w * s.w;
    const float disc = b * b - a * c;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t1 = (-b - sq) * inv_a;
    const float t2 = (-b + sq) * inv_a;
    float t = (t1 > kTMin) ? t1 : ((t2 > kTMin) ? t2 : kTFar);
    t = (disc >= 0.0f) ? t : kTFar;
    if (t < best_t) {
      best_t = t;
      best = i;
    }
  }
  return best;
}

// _shade_tile (pallas_kernels.py:167): hit point and scattered direction.
__device__ __forceinline__ void shade(
    uint32_t base, uint32_t sample, uint32_t bounce,
    float ox, float oy, float oz, float dx, float dy, float dz,
    float best_t, float cx, float cy, float cz, float inv_r,
    float fuzz, float ior, float mt,
    float& p_x, float& p_y, float& p_z,
    float& ndx, float& ndy, float& ndz) {
  uint32_t st = jenkins(base + sample * kSampleStride
                        + (bounce + 1u) * kBounceStride);
  (void)pcg_next(st);   // ball-radius draw: unused, but advances the stream
  const float u2 = next_f32(st);
  const float u3 = next_f32(st);
  const float r_reflect = next_f32(st);

  const float cos_th = 1.0f - 2.0f * u2;
  const float sin_th = sqrtf(fmaxf(0.0f, 1.0f - cos_th * cos_th));
  const float phi = kTwoPi * u3;
  const float sx = sin_th * cosf(phi);
  const float sy = sin_th * sinf(phi);
  const float sz = cos_th;

  p_x = ox + best_t * dx;
  p_y = oy + best_t * dy;
  p_z = oz + best_t * dz;
  float nx = (p_x - cx) * inv_r;
  float ny = (p_y - cy) * inv_r;
  float nz = (p_z - cz) * inv_r;
  const float n_norm = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-37f));
  nx *= n_norm;
  ny *= n_norm;
  nz *= n_norm;

  float lx = nx + sx, ly = ny + sy, lz = nz + sz;
  if (lx * lx + ly * ly + lz * lz < 1e-6f) {
    lx = nx;
    ly = ny;
    lz = nz;
  }

  const float d_dot_n = dx * nx + dy * ny + dz * nz;
  const float mx = (dx - 2.0f * d_dot_n * nx) + fuzz * sx;
  const float my = (dy - 2.0f * d_dot_n * ny) + fuzz * sy;
  const float mz = (dz - 2.0f * d_dot_n * nz) + fuzz * sz;

  float cos_theta = fminf(-d_dot_n, 1.0f);
  const bool outside = cos_theta >= 0.0f;
  const float eta = outside ? 1.0f / ior : ior;
  const float fnx = outside ? nx : -nx;
  const float fny = outside ? ny : -ny;
  const float fnz = outside ? nz : -nz;
  cos_theta = fabsf(cos_theta);
  float r0 = (1.0f - eta) / (1.0f + eta);
  r0 = r0 * r0;
  const float one_m = 1.0f - cos_theta;
  const float om2 = one_m * one_m;
  const float reflectance = r0 + (1.0f - r0) * om2 * om2 * one_m;
  const float cos_in = dx * fnx + dy * fny + dz * fnz;
  const float kk = 1.0f - eta * eta * (1.0f - cos_in * cos_in);
  const bool take_refract = (kk >= 0.0f) && (reflectance <= r_reflect);
  float gx, gy, gz;
  if (take_refract) {
    const float coef = eta * cos_in + sqrtf(fmaxf(kk, 0.0f));
    gx = eta * dx - coef * fnx;
    gy = eta * dy - coef * fny;
    gz = eta * dz - coef * fnz;
  } else {
    gx = dx - 2.0f * cos_in * fnx;
    gy = dy - 2.0f * cos_in * fny;
    gz = dz - 2.0f * cos_in * fnz;
  }

  if (mt == 2.0f) {
    ndx = gx; ndy = gy; ndz = gz;
  } else if (mt == 1.0f) {
    ndx = mx; ndy = my; ndz = mz;
  } else {
    ndx = lx; ndy = ly; ndz = lz;
  }
  const float inv_len = rsqrtf(fmaxf(ndx * ndx + ndy * ndy + ndz * ndz,
                                     1e-24f));
  ndx *= inv_len;
  ndy *= inv_len;
  ndz *= inv_len;
}

struct Params {
  const float* scene;       // (S, 16) f32, NaN padding rows
  int n_rows;               // table rows to sweep (n_spheres rounded up to 8)
  const float* cam;         // (24,) f32, layout of _raygen_tile
  const uint32_t* pix;      // lane planes, n_lanes each
  const float* xs;
  const float* ys;
  const float* valid;
  const uint32_t* soff;
  float* rad_r;
  float* rad_g;
  float* rad_b;
  int* rays;                // per-lane rays traced
  int n_lanes;
  uint32_t frame, sample_base, max_bounces, n_samples;
  uint32_t rr_start;        // 0 = roulette off
  float rr_floor;
  float clamp;              // 0 = off
  int stratified;
};

__global__ void __launch_bounds__(kThreads)
persistent_kernel(const Params p) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.n_lanes) return;

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  int rays = 0;
  if (p.valid[lane] > 0.0f) {
    Camera cam;
#pragma unroll
    for (int k = 0; k < 9; ++k) cam.r[k] = __ldg(p.cam + k);
#pragma unroll
    for (int k = 0; k < 3; ++k) cam.pos[k] = __ldg(p.cam + 9 + k);
    cam.w_scale = __ldg(p.cam + 12);
    cam.h_scale = __ldg(p.cam + 13);
    cam.z_far = __ldg(p.cam + 14);
    cam.defocus_radius = __ldg(p.cam + 15);
    cam.focus_distance = __ldg(p.cam + 16);
    cam.width = __ldg(p.cam + 17);
    cam.height = __ldg(p.cam + 18);

    const float4* rows = reinterpret_cast<const float4*>(p.scene);
    const uint32_t pix = p.pix[lane];
    const float xs = p.xs[lane];
    const float ys = p.ys[lane];
    const uint32_t soff = p.soff[lane];
    const uint32_t base = jenkins(pix ^ jenkins(p.frame));
    const bool stratified = p.stratified != 0;

    for (uint32_t s = 0; s < p.n_samples; ++s) {
      const uint32_t sample = p.sample_base + soff + s;
      float ox, oy, oz, dx, dy, dz;
      raygen(cam, xs, ys, base, sample, stratified, ox, oy, oz, dx, dy, dz);
      float tr = 1.0f, tg = 1.0f, tb = 1.0f;
      uint32_t bounce = 0;
      while (true) {
        ++rays;
        float best_t;
        const int w = intersect(rows, p.n_rows, ox, oy, oz, dx, dy, dz,
                                best_t);
        if (!(best_t < kTFar)) {
          // Miss: throughput x sky gradient, optionally clamped.
          const float sky_a = 0.5f * (dy + 1.0f);
          float con_r = tr * ((1.0f - sky_a) + sky_a * 0.5f);
          float con_g = tg * ((1.0f - sky_a) + sky_a * 0.7f);
          float con_b = tb * ((1.0f - sky_a) + sky_a * 1.0f);
          if (p.clamp > 0.0f) {
            con_r = fminf(con_r, p.clamp);
            con_g = fminf(con_g, p.clamp);
            con_b = fminf(con_b, p.clamp);
          }
          acc_r += con_r;
          acc_g += con_g;
          acc_b += con_b;
          break;
        }
        const float4 geo = __ldg(rows + 4 * w);       // centre, radius
        const float4 alb = __ldg(rows + 4 * w + 1);   // albedo rgb, fuzz
        const float4 mat = __ldg(rows + 4 * w + 2);   // ior, mat_type
        float px, py, pz, ndx, ndy, ndz;
        shade(base, sample, bounce, ox, oy, oz, dx, dy, dz, best_t,
              geo.x, geo.y, geo.z, 1.0f / geo.w, alb.w, mat.x, mat.y,
              px, py, pz, ndx, ndy, ndz);
        ox = px; oy = py; oz = pz;
        dx = ndx; dy = ndy; dz = ndz;
        tr *= alb.x;
        tg *= alb.y;
        tb *= alb.z;
        ++bounce;
        if (p.rr_start != 0u && bounce >= p.rr_start) {
          uint32_t st = jenkins((base + sample * kSampleStride
                                 + bounce * kBounceStride) ^ kRrSalt);
          const float u_rr = next_f32(st);
          const float keep_p = fminf(fmaxf(fmaxf(tr, fmaxf(tg, tb)),
                                           p.rr_floor), 1.0f);
          if (!(u_rr < keep_p)) break;
          const float inv_p = 1.0f / keep_p;
          tr *= inv_p;
          tg *= inv_p;
          tb *= inv_p;
        }
        if (bounce >= p.max_bounces) break;
      }
    }
  }
  p.rad_r[lane] = acc_r;
  p.rad_g[lane] = acc_g;
  p.rad_b[lane] = acc_b;
  p.rays[lane] = rays;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// wrapper (ops/fused_kernels.py) checks shapes, types and alignment.
extern "C" int wpt_persistent_launch(
    const float* scene, int n_rows, const float* cam,
    const uint32_t* pix, const float* xs, const float* ys,
    const float* valid, const uint32_t* soff,
    float* rad_r, float* rad_g, float* rad_b, int* rays, int n_lanes,
    uint32_t frame, uint32_t sample_base, uint32_t max_bounces,
    uint32_t n_samples, uint32_t rr_start, float rr_floor, float clamp,
    int stratified, void* stream) {
  if (n_lanes <= 0) return 0;
  Params p{scene, n_rows, cam, pix, xs, ys, valid, soff,
           rad_r, rad_g, rad_b, rays, n_lanes,
           frame, sample_base, max_bounces, n_samples,
           rr_start, rr_floor, clamp, stratified};
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  persistent_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
