// Device code shared by the persistent-lane kernels (persistent.cu,
// baked.cu): the PCG streams, primary-ray generation, shading, and the
// per-lane sample and bounce loop with the sky/miss accumulation, the
// clamp and Russian roulette.  Each kernel supplies only its nearest-hit
// function (see trace_lane).
//
// Port of wavefront_path_tracer_tpu/ops/pallas_kernels.py: _jenkins /
// _pcg_next / _next_f32 (81-103), _raygen_tile (461), _shade_tile (167)
// and the loop body of _persistent_impl (2451).  Every float operation is
// written in the reference's order; with -fmad=false (ops/_build.py) the
// results are bit-identical to the plain PyTorch versions in
// ops/fused_kernels.py.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wpt {

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

__device__ __forceinline__ Camera load_camera(const float* __restrict__ c) {
  Camera cam;
#pragma unroll
  for (int k = 0; k < 9; ++k) cam.r[k] = __ldg(c + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) cam.pos[k] = __ldg(c + 9 + k);
  cam.w_scale = __ldg(c + 12);
  cam.h_scale = __ldg(c + 13);
  cam.z_far = __ldg(c + 14);
  cam.defocus_radius = __ldg(c + 15);
  cam.focus_distance = __ldg(c + 16);
  cam.width = __ldg(c + 17);
  cam.height = __ldg(c + 18);
  return cam;
}

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

// The winner of a nearest-hit search: what shade and the throughput
// update read.
struct Hit {
  float t;
  float cx, cy, cz, inv_r;   // world-space centre; 1/r or its sign
  float ar, ag, ab;          // albedo
  float fuzz, ior, mt;       // mt: 0 Lambertian, 1 metal, 2 dielectric
};

// Per-lane counters; a nearest-hit function adds its cull entries.
struct Counts {
  int rays = 0;
  int supers = 0;
  int clusters = 0;
};

// _shade_tile (pallas_kernels.py:167): hit point and scattered direction.
__device__ __forceinline__ void shade(
    uint32_t base, uint32_t sample, uint32_t bounce,
    float ox, float oy, float oz, float dx, float dy, float dz,
    const Hit& h,
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

  p_x = ox + h.t * dx;
  p_y = oy + h.t * dy;
  p_z = oz + h.t * dz;
  float nx = (p_x - h.cx) * h.inv_r;
  float ny = (p_y - h.cy) * h.inv_r;
  float nz = (p_z - h.cz) * h.inv_r;
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
  const float mx = (dx - 2.0f * d_dot_n * nx) + h.fuzz * sx;
  const float my = (dy - 2.0f * d_dot_n * ny) + h.fuzz * sy;
  const float mz = (dz - 2.0f * d_dot_n * nz) + h.fuzz * sz;

  float cos_theta = fminf(-d_dot_n, 1.0f);
  const bool outside = cos_theta >= 0.0f;
  const float eta = outside ? 1.0f / h.ior : h.ior;
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

  if (h.mt == 2.0f) {
    ndx = gx; ndy = gy; ndz = gz;
  } else if (h.mt == 1.0f) {
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

// Lane planes, outputs and salts of one persistent-lane launch.
struct LaneParams {
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
  int* supers;              // per-lane supers entered (nullptr: not kept)
  int* clusters;            // per-lane clusters entered (nullptr: not kept)
  int n_lanes;
  uint32_t frame, sample_base, max_bounces, n_samples;
  uint32_t rr_start;        // 0 = roulette off
  float rr_floor;
  float clamp;              // 0 = off
  int stratified;
};

// The persistent body (_persistent_impl) for one lane: every sample and
// every bounce of the lane, one thread.  `isect(ox, oy, oz, dx, dy, dz,
// hit, counts)` returns whether the ray hits and fills `hit`.  Each lane
// writes its own radiance words and counters once: no atomics, and the
// result is deterministic.
template <class Isect>
__device__ __forceinline__ void trace_lane(const LaneParams& p, int lane,
                                           const Isect& isect) {
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  Counts counts;
  if (p.valid[lane] > 0.0f) {
    const Camera cam = load_camera(p.cam);
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
        ++counts.rays;
        Hit h;
        if (!isect(ox, oy, oz, dx, dy, dz, h, counts)) {
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
        float px, py, pz, ndx, ndy, ndz;
        shade(base, sample, bounce, ox, oy, oz, dx, dy, dz, h,
              px, py, pz, ndx, ndy, ndz);
        ox = px; oy = py; oz = pz;
        dx = ndx; dy = ndy; dz = ndz;
        tr *= h.ar;
        tg *= h.ag;
        tb *= h.ab;
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
  p.rays[lane] = counts.rays;
  if (p.supers != nullptr) p.supers[lane] = counts.supers;
  if (p.clusters != nullptr) p.clusters[lane] = counts.clusters;
}

}  // namespace wpt
