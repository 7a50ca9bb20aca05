// Device code shared by the persistent-lane kernels (persistent.cu,
// baked.cu, dynculled.cu): the PCG streams, primary-ray generation,
// shading, the per-lane sample and bounce loop with the sky/miss
// accumulation, the clamp and Russian roulette, the texture step, and the
// box and triangle tests of the culled intersects; and the recluster
// segment body (trace_segment per thread, trace_segment_warp with the
// warp's lanes in step), which runs the same bounce step from and back
// into stored lane state.  Each kernel supplies only its nearest-hit
// function (see bounce_step).  The differential stage probes (kProbe,
// below) are template arguments of trace_warp and of the culled
// intersects (which a segment runs too): a kernel instantiated with 0 is
// the shipped one.
//
// Port of wavefront_path_tracer_tpu/ops/pallas_kernels.py: _jenkins /
// _pcg_next / _next_f32 (81-103), _raygen_tile (461), _shade_tile (167),
// the loop body of _persistent_impl (2451) with its checker select
// (2694-2702), the loop body of _segment_impl (2785),
// _apply_image_textures (298) with _acos_approx (274) and _atan2_approx
// (283), box_range (1245) and the two-sided Moller-Trumbore test of
// tri_tests (1191).  Every float operation is written in the reference's
// order; with -fmad=false
// (ops/_build.py) the results are bit-identical to the plain PyTorch
// versions in ops/fused_kernels.py.

#pragma once

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "fastmath.cuh"

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
constexpr unsigned kFullMask = 0xffffffffu;   // all 32 lanes of a warp
// The texture step's constants, rounded from the reference's float64
// Python values to float32 as JAX and PyTorch round them.
constexpr float kPiF = (float)3.1415927;
constexpr float kHalfPiF = (float)1.5707963;
constexpr float kInv2Pi = (float)(1.0 / (2.0 * 3.1415927));
constexpr float kInvPi = (float)(1.0 / 3.1415927);
constexpr float kInv1023 = (float)(1.0 / 1023.0);

// The differential stage probes (ops/stage_probes.py PROBES, where each
// name has the bit below): the port of the reference's PROBE flags
// (pallas_kernels.py:61), read at compile time as the reference read them
// at trace time.  A kernel instantiated with one of these bits runs one
// stage twice, the second time from inputs shifted by an opaque zero
// (opaque_zero), so that nvcc cannot merge the two, and keeps results
// equal to the unprobed kernel's (dbl_accum: up to rounding); its time
// against the unprobed kernel's is the stage's share (models/fused.py
// stage_timing).  Probe 0 is the shipped kernel: every probe site is an
// `if constexpr`, so its code is the unprobed code.
constexpr int kDblRaygen = 1 << 0;     // trace_warp: raygen
constexpr int kDblShade = 1 << 1;      // bounce_finish: shade
constexpr int kDblAccum = 1 << 2;      // bounce_finish: the sky add
constexpr int kDblLoopcond = 1 << 3;   // trace_warp: the trip vote
constexpr int kDblEntry = 1 << 4;      // baked.cu: an entered cluster
constexpr int kDblCond = 1 << 5;       // baked.cu: cluster and super conds
constexpr int kDynDblEntry = 1 << 6;   // dynculled.cu: an entered cluster
constexpr int kDynDblCond = 1 << 7;    // dynculled.cu: the conds
constexpr int kDynDblGlobal = 1 << 8;  // dynculled.cu: the globals
constexpr int kDblEntry2 = 1 << 9;     // baked.cu: an entered sphere cluster
                                       //   from a shifted origin
constexpr int kDblCond2 = 1 << 10;     // baked.cu: cluster conds, shifted box
constexpr int kHintCount = 1 << 11;    // baked.cu: the hint's prepass counted
// The probes of the warp's loop (trace_warp, bounce_finish): a segment has
// none, as _segment_impl has none; the others are the intersects'.
constexpr int kLoopProbes = kDblRaygen | kDblShade | kDblAccum | kDblLoopcond;

// +0.0f from an inline-asm move that nvcc cannot see through: added to
// the inputs of a probe's duplicate stage, it changes no value (but
// the sign of a zero, which no compare of the stage reads) and keeps
// nvcc from merging the duplicate with the original.
__device__ __forceinline__ uint32_t opaque_zero_bits() {
  uint32_t z;
  asm volatile("mov.u32 %0, 0;" : "=r"(z));
  return z;
}

__device__ __forceinline__ float opaque_zero() {
  return __uint_as_float(opaque_zero_bits());
}

// The host side of a probe launch: f(std::integral_constant<int, bit>)
// for the one listed bit that equals `probe`; false if none does (the
// launchers of baked_probe*.cu and dynculled_probe*.cu).
template <int... kBits, class F>
bool with_probe_bit(int probe, F f) {
  return ((probe == kBits
           && (f(std::integral_constant<int, kBits>{}), true)) || ...);
}

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
// update read.  The triangle fields are read only by kernels whose
// nearest-hit function has kTriangles set, the texture fields only by
// those with kTextured set; other kernels never write them, so they cost
// those kernels nothing.
struct Hit {
  float t;
  float cx, cy, cz, inv_r;   // world-space centre; 1/r or its sign
  float ar, ag, ab;          // albedo
  float fuzz, ior, mt;       // mt: 0 Lambertian, 1 metal, 2 dielectric
  float nx, ny, nz;          // a triangle winner's unit normal
  bool is_tri;               // the winner is a triangle
  float a2r, a2g, a2b, ts;   // checker second albedo and scale (0: none)
  int slot;                  // image slot, -1: none (always for a triangle)
};

// jnp.minimum / jnp.maximum (and torch's): NaN in, NaN out; fminf and
// fmaxf would drop a NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Image LUTs of a textured launch (ops/textures.py): per slot the
// sphere's centre and 1/r, and (slots, h * w) words of 10:10:10 texels.
struct TexTables {
  const float4* centres;
  const int* words;
  int h, w;
};

// _acos_approx (pallas_kernels.py:274): A&S 4.4.45, in its order.
__device__ __forceinline__ float acos_approx(float x) {
  const float a = fabsf(x);
  const float base = sqrtf(nan_max(1.0f - a, 0.0f)) * (
      (float)1.5707288 + a * ((float)-0.2121144 + a * (
          (float)0.0742610 - (float)0.0187293 * a)));
  return (x < 0.0f) ? kPiF - base : base;
}

// _atan2_approx (pallas_kernels.py:283): A&S 4.4.49, an IEEE division.
__device__ __forceinline__ float atan2_approx(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float mx = nan_max(ax, ay);
  const float z = nan_min(ax, ay) / nan_max(mx, (float)1e-30);
  const float z2 = z * z;
  float at = z * ((float)0.9998660 + z2 * ((float)-0.3302995 + z2 * (
      (float)0.1801410 + z2 * ((float)-0.0851330
                               + (float)0.0208351 * z2))));
  at = (ay > ax) ? kHalfPiF - at : at;
  at = (x < 0.0f) ? kPiF - at : at;
  return (y < 0.0f) ? -at : at;
}

// The checker select: sin(a) sin(b) sin(c) < 0, with sinf's values.
// Where the three arguments lie in the range of sinf's fast path, their
// sines are fastmath.cuh's sinf_fast, one straight line of code with no
// branch; else sinf, slow path and all, behind one range test of the
// three.  Equal to the product of the three sinf calls for every input:
// sinf_fast is sinf bit for bit on its range (the smoke checks all 2^32
// floats), and the product is formed in the same order.  The fallback
// stays inline: out of line (__noinline__) it cost every textured kernel
// 24 bytes of stack for the call.
__device__ __forceinline__ bool checker_select(float a, float b, float c) {
  if (fabsf(a) >= kSinFastMax || fabsf(b) >= kSinFastMax
      || fabsf(c) >= kSinFastMax) {
    return sinf(a) * sinf(b) * sinf(c) < 0.0f;
  }
  return sinf_fast(a) * sinf_fast(b) * sinf_fast(c) < 0.0f;
}

// The texture step of _persistent_impl (2694-2707) for a hit at p: the
// checker select (a scale of 0 never selects: sin(0 * p) is 0), then,
// for a sphere winner with an image slot, the texel at the equirect UV
// of p: one 4-byte read of a packed word, which L1 holds (book_checker's
// LUT is 8 KB).  The TPU evaluated the LUT as a select tree per tile that
// saw the sphere, and found the sphere by its centre and 1/r; here the
// winner carries its slot, which agrees unless two spheres share centre
// and signed radius.
__device__ __forceinline__ void apply_textures(
    const TexTables& tex, const Hit& h, float px, float py, float pz,
    float& ar, float& ag, float& ab) {
  if (h.ts != 0.0f) {
    const float s = h.ts;
    if (checker_select(s * px, s * py, s * pz)) {
      ar = h.a2r;
      ag = h.a2g;
      ab = h.a2b;
    }
  }
  if (h.slot < 0) return;
  const float4 c = __ldg(tex.centres + h.slot);
  const float nx = (px - c.x) * c.w;
  const float ny = (py - c.y) * c.w;
  const float nz = (pz - c.z) * c.w;
  const float u = (atan2_approx(-nz, nx) + kPiF) * kInv2Pi;
  const float v = acos_approx(nan_min(nan_max(-ny, -1.0f), 1.0f)) * kInvPi;
  const int yi = min(max((int)((1.0f - v) * (float)tex.h), 0), tex.h - 1);
  const int xi = min(max((int)(u * (float)tex.w), 0), tex.w - 1);
  const int word = __ldg(tex.words + (size_t)h.slot * tex.h * tex.w
                         + yi * tex.w + xi);
  ar = (float)((word >> 20) & 1023) * kInv1023;
  ag = (float)((word >> 10) & 1023) * kInv1023;
  ab = (float)(word & 1023) * kInv1023;
}

// Per-lane counters; a nearest-hit function adds its cull entries.
struct Counts {
  int rays = 0;
  int supers = 0;
  int clusters = 0;
};

// _shade_tile (pallas_kernels.py:167): hit point and scattered direction.
// With kTris, a triangle winner takes its geometric normal, flipped
// toward the ray unless it is a dielectric (209-218).
template <bool kTris>
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
  if (kTris && h.is_tri) {
    const float d_dot_tn = dx * h.nx + dy * h.ny + dz * h.nz;
    const bool flip = (d_dot_tn > 0.0f) && (h.mt != 2.0f);
    nx = flip ? -h.nx : h.nx;
    ny = flip ? -h.ny : h.ny;
    nz = flip ? -h.nz : h.nz;
  }

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

// The state of one path between bounces.
struct Path {
  float ox, oy, oz, dx, dy, dz;
  float tr, tg, tb;           // throughput
  float acc_r, acc_g, acc_b;  // radiance gathered
  uint32_t bounce;            // surface events so far
};

// What follows the nearest-hit search in one bounce of a live path
// (`hit`: whether the ray hit, and then `h` its winner): the loop body of
// _persistent_impl (2451) and of _segment_impl (2854-2936) after the
// intersect, shared by bounce_step and trace_warp so that they cannot
// drift.  Isect::kTriangles says whether the winner may be a triangle and
// Isect::kTextured whether the texture step runs (over isect.tex).  A
// miss adds throughput x the sky gradient (optionally clamped) and ends
// the path; a hit shades, applies the texture step, scatters, and runs
// roulette from rr_start.  Returns whether the path goes on.  `P` is
// LaneParams or SegParams: its max_bounces, rr_start, rr_floor and clamp.
// Probes (trace_warp's kProbe): kDblAccum adds the sky contribution as two
// halves, the second plus an opaque zero (pallas_kernels.py:2673-2679;
// acc + c/2 + c/2 rounds unlike acc + c); kDblShade shades twice, the
// second time from the origin and the stream base shifted by an opaque
// zero, and takes the mean of the two equal results (2685-2693).
template <class Isect, class P, int kProbe = 0>
__device__ __forceinline__ bool bounce_finish(const P& p, const Isect& isect,
                                              uint32_t base, uint32_t sample,
                                              Path& q, bool hit,
                                              const Hit& h) {
  if (!hit) {
    const float sky_a = 0.5f * (q.dy + 1.0f);
    float con_r = q.tr * ((1.0f - sky_a) + sky_a * 0.5f);
    float con_g = q.tg * ((1.0f - sky_a) + sky_a * 0.7f);
    float con_b = q.tb * ((1.0f - sky_a) + sky_a * 1.0f);
    if (p.clamp > 0.0f) {
      con_r = fminf(con_r, p.clamp);
      con_g = fminf(con_g, p.clamp);
      con_b = fminf(con_b, p.clamp);
    }
    if constexpr ((kProbe & kDblAccum) != 0) {
      const float z = opaque_zero();
      q.acc_r += con_r * 0.5f;
      q.acc_g += con_g * 0.5f;
      q.acc_b += con_b * 0.5f;
      q.acc_r += con_r * 0.5f + z;
      q.acc_g += con_g * 0.5f + z;
      q.acc_b += con_b * 0.5f + z;
    } else {
      q.acc_r += con_r;
      q.acc_g += con_g;
      q.acc_b += con_b;
    }
    return false;
  }
  float px, py, pz, ndx, ndy, ndz;
  shade<Isect::kTriangles>(base, sample, q.bounce, q.ox, q.oy, q.oz, q.dx,
                           q.dy, q.dz, h, px, py, pz, ndx, ndy, ndz);
  if constexpr ((kProbe & kDblShade) != 0) {
    const uint32_t zi = opaque_zero_bits();
    const float z = __uint_as_float(zi);
    float px2, py2, pz2, ndx2, ndy2, ndz2;
    shade<Isect::kTriangles>(base + zi, sample, q.bounce, q.ox + z, q.oy,
                             q.oz, q.dx, q.dy, q.dz, h, px2, py2, pz2, ndx2,
                             ndy2, ndz2);
    px = 0.5f * (px + px2);
    py = 0.5f * (py + py2);
    pz = 0.5f * (pz + pz2);
    ndx = 0.5f * (ndx + ndx2);
    ndy = 0.5f * (ndy + ndy2);
    ndz = 0.5f * (ndz + ndz2);
  }
  float ar = h.ar, ag = h.ag, ab = h.ab;
  if constexpr (Isect::kTextured) {
    apply_textures(isect.tex, h, px, py, pz, ar, ag, ab);
  }
  q.ox = px; q.oy = py; q.oz = pz;
  q.dx = ndx; q.dy = ndy; q.dz = ndz;
  q.tr *= ar;
  q.tg *= ag;
  q.tb *= ab;
  ++q.bounce;
  if (p.rr_start != 0u && q.bounce >= p.rr_start) {
    uint32_t st = jenkins((base + sample * kSampleStride
                           + q.bounce * kBounceStride) ^ kRrSalt);
    const float u_rr = next_f32(st);
    const float keep_p = fminf(fmaxf(fmaxf(q.tr, fmaxf(q.tg, q.tb)),
                                     p.rr_floor), 1.0f);
    if (!(u_rr < keep_p)) return false;
    const float inv_p = 1.0f / keep_p;
    q.tr *= inv_p;
    q.tg *= inv_p;
    q.tb *= inv_p;
  }
  return q.bounce < p.max_bounces;
}

// One bounce of a live path, shared by trace_lane and trace_segment:
// `isect(ox, oy, oz, dx, dy, dz, hit, counts, hint)` returns whether the
// ray hits and fills `hit`; then bounce_finish.
template <class Isect, class P>
__device__ __forceinline__ bool bounce_step(const P& p, const Isect& isect,
                                            uint32_t base, uint32_t sample,
                                            Path& q, Counts& counts,
                                            int& hint) {
  Hit h;
  const bool hit = isect(q.ox, q.oy, q.oz, q.dx, q.dy, q.dz, h, counts,
                         hint);
  return bounce_finish(p, isect, base, sample, q, hit, h);
}

// The persistent body (_persistent_impl) for one lane: every sample and
// every bounce of the lane, one thread.  `hint` is the lane's state for
// the winner hint: -1 for a new lane, then whatever the last call left
// (intersects without a hint ignore it).  Each lane writes its own
// radiance words and counters once: no atomics, and the result is
// deterministic.
template <class Isect>
__device__ __forceinline__ void trace_lane(const LaneParams& p, int lane,
                                           const Isect& isect) {
  Path q;
  q.acc_r = 0.0f;
  q.acc_g = 0.0f;
  q.acc_b = 0.0f;
  Counts counts;
  int hint = -1;
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
      raygen(cam, xs, ys, base, sample, stratified, q.ox, q.oy, q.oz, q.dx,
             q.dy, q.dz);
      q.tr = 1.0f;
      q.tg = 1.0f;
      q.tb = 1.0f;
      q.bounce = 0;
      do {
        ++counts.rays;
      } while (bounce_step(p, isect, base, sample, q, counts, hint));
    }
  }
  p.rad_r[lane] = q.acc_r;
  p.rad_g[lane] = q.acc_g;
  p.rad_b[lane] = q.acc_b;
  p.rays[lane] = counts.rays;
  if (p.supers != nullptr) p.supers[lane] = counts.supers;
  if (p.clusters != nullptr) p.clusters[lane] = counts.clusters;
}

// trace_lane with the warp's lanes in step: for nearest-hit functions
// that vote and shuffle across the warp (the cooperative culled sweeps
// of baked.cu and dynculled.cu) or stage a table a warp at a time, and
// for the unculled sweeps (persistent.cu, baked.cu), whose lanes then
// read each table row in the same trip, one broadcast a row.  In
// trace_lane a lane that has finished its samples leaves, and the lanes
// reach the intersect at unrelated points, so no warp-wide
// __ballot_sync, __shfl_sync or __syncwarp is safe there.  Here the warp
// runs one loop of trips, and in each trip every lane of the warp, those
// past n_lanes too, calls
// `isect(live, ox, oy, oz, dx, dy, dz, hit, counts, hint)` once: a lane
// with a ray passes live = true, one with none left live = false, and then
// enters nothing and counts nothing but still joins every vote, shuffle
// and staging.  The loop ends when no lane of the warp is live.  Each
// lane traces the rays of trace_lane in the same order (a lane starts its
// next sample on the trip after its path ends), so its radiance words, its
// streams and its counters are trace_lane's, and the trips of a warp are
// still the largest ray count among its lanes.
//
// kProbe (the bits above; 0 in the shipped kernels) duplicates a stage of
// the loop: kDblRaygen runs raygen twice, the second time from xs and the
// stream base shifted by an opaque zero, and takes the mean of the two
// equal rays (pallas_kernels.py:2611-2616); kDblLoopcond takes the trip
// vote twice, the second from `live` against an opaque zero, and ANDs
// them (2550-2554); kDblShade and kDblAccum are bounce_finish's.  A
// duplicate's votes stay here, in the warp's loop, where every lane joins
// them.
template <int kProbe>
__device__ __forceinline__ bool trip_vote(bool live) {
  const bool go = __any_sync(kFullMask, live);
  if constexpr ((kProbe & kDblLoopcond) != 0) {
    return go & __any_sync(kFullMask, live != (opaque_zero_bits() != 0u));
  }
  return go;
}

template <int kProbe = 0, class Isect>
__device__ __forceinline__ void trace_warp(const LaneParams& p, int lane,
                                           const Isect& isect) {
  const bool in = lane < p.n_lanes;
  Path q;
  q.ox = 0.0f; q.oy = 0.0f; q.oz = 0.0f;
  q.dx = 0.0f; q.dy = 0.0f; q.dz = 0.0f;
  q.acc_r = 0.0f;
  q.acc_g = 0.0f;
  q.acc_b = 0.0f;
  Counts counts;
  int hint = -1;
  bool live = in && p.n_samples > 0 && p.valid[lane] > 0.0f;
  uint32_t pix = 0, soff = 0;
  float xs = 0.0f, ys = 0.0f;
  if (live) {
    pix = p.pix[lane];
    xs = p.xs[lane];
    ys = p.ys[lane];
    soff = p.soff[lane];
  }
  const Camera cam = load_camera(p.cam);
  const uint32_t base = jenkins(pix ^ jenkins(p.frame));
  const bool stratified = p.stratified != 0;
  uint32_t s = 0, sample = 0;
  bool fresh = true;       // the lane's next ray starts a sample
  while (trip_vote<kProbe>(live)) {
    if (live && fresh) {
      sample = p.sample_base + soff + s;
      raygen(cam, xs, ys, base, sample, stratified, q.ox, q.oy, q.oz, q.dx,
             q.dy, q.dz);
      if constexpr ((kProbe & kDblRaygen) != 0) {
        const uint32_t zi = opaque_zero_bits();
        float ox2, oy2, oz2, dx2, dy2, dz2;
        raygen(cam, xs + __uint_as_float(zi), ys, base + zi, sample,
               stratified, ox2, oy2, oz2, dx2, dy2, dz2);
        q.ox = 0.5f * (q.ox + ox2);
        q.oy = 0.5f * (q.oy + oy2);
        q.oz = 0.5f * (q.oz + oz2);
        q.dx = 0.5f * (q.dx + dx2);
        q.dy = 0.5f * (q.dy + dy2);
        q.dz = 0.5f * (q.dz + dz2);
      }
      q.tr = 1.0f;
      q.tg = 1.0f;
      q.tb = 1.0f;
      q.bounce = 0;
      fresh = false;
    }
    Hit h;
    const bool hit = isect(live, q.ox, q.oy, q.oz, q.dx, q.dy, q.dz, h,
                           counts, hint);
    if (live) {
      ++counts.rays;
      if (!bounce_finish<Isect, LaneParams, kProbe>(p, isect, base, sample,
                                                    q, hit, h)) {
        fresh = true;
        live = ++s < p.n_samples;
      }
    }
  }
  if (!in) return;
  p.rad_r[lane] = q.acc_r;
  p.rad_g[lane] = q.acc_g;
  p.rad_b[lane] = q.acc_b;
  p.rays[lane] = counts.rays;
  if (p.supers != nullptr) p.supers[lane] = counts.supers;
  if (p.clusters != nullptr) p.clusters[lane] = counts.clusters;
}

// The form of a culled sweep (baked.cu's and dynculled.cu's), for
// spheres and triangles alike: the lanes that share one ray (G) and the
// most entering lanes of a warp for which a cluster takes the cooperative
// fold (T).  T = 0 is the serial fold of every cluster in the per-thread
// loops (trace_lane, trace_segment); T above 0 votes per cluster, which
// needs the warp's lanes in step (trace_warp, trace_segment_warp).
template <int kGroup, int kMaxLanes>
struct Sweep {
  static constexpr int kG = kGroup, kT = kMaxLanes;
  static constexpr bool kWarp = kMaxLanes > 0;
  static_assert(!kWarp || (kGroup >= 2 && kGroup <= 32 && 32 % kGroup == 0),
                "G divides the warp");
};
// The per-thread sweep of every cluster: the T = 0 comparator, in the
// persistent loop and in a segment alike.
using Serial = Sweep<1, 0>;
// The shipped form of both culled sweeps, chosen on the card (PERF.md
// section 6).
using Coop = Sweep<8, 12>;

// The cooperative fold of one cluster, items first..first+count-1, for
// the entering lanes `m` of the warp; every lane of the warp calls it,
// with `took` set where the lane's best changed.  G lanes serve one
// entering ray, 32 / G rays a pass, taken from m in lane order.  A group
// reads its ray's N fields with `fetch(owner, v)`, and lane j of the group
// tests items first + j, first + j + G, ... with `item_t(v, i)`, keeping
// its first strict minimum (t, i).  A shuffle tree over the group keeps
// the smaller t and, on equal t, the smaller index; the entering lane
// takes the result (tagged with `tag`) only where it is strictly below
// the best_t it held before the cluster.  So its winner is the serial
// fold's, bit for bit: the first item of least t below the old best.
// Lanes without an item hold (kTFar, INT_MAX), which never wins.
template <int G, int N, class Fetch, class ItemT>
__device__ __forceinline__ bool coop_fold(unsigned m, int first, int count,
                                          int tag, Fetch fetch, ItemT item_t,
                                          float& best_t, int& best) {
  constexpr int kGroups = 32 / G;
  const int me = static_cast<int>(threadIdx.x & 31u);
  const int g = me / G;
  const int j = me % G;
  const unsigned below = (1u << me) - 1u;
  bool took = false;
  for (unsigned rem = m; rem != 0u;) {
    unsigned x = rem;              // group g serves the g-th lane of rem
    for (int k = 0; k < g; ++k) x &= x - 1u;
    const bool serves = x != 0u;
    float v[N];
    fetch(serves ? __ffs(x) - 1 : me, v);
    float t_min = kTFar;
    int i_min = INT_MAX;
    if (serves) {
      for (int i = first + j; i < first + count; i += G) {
        const float t = item_t(v, i);
        if (t < t_min) {
          t_min = t;
          i_min = i;
        }
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      const float t2 = __shfl_xor_sync(kFullMask, t_min, off);
      const int i2 = __shfl_xor_sync(kFullMask, i_min, off);
      if (t2 < t_min || (t2 == t_min && i2 < i_min)) {
        t_min = t2;
        i_min = i2;
      }
    }
    const int rank = __popc(rem & below);
    const bool served = ((rem >> me) & 1u) && rank < kGroups;
    const int src = served ? rank * G : me;
    const float t_res = __shfl_sync(kFullMask, t_min, src);
    const int i_res = __shfl_sync(kFullMask, i_min, src);
    if (served && t_res < best_t) {
      best_t = t_res;
      best = tag | i_res;
      took = true;
    }
#pragma unroll
    for (int k = 0; k < kGroups; ++k) rem &= rem - 1u;
  }
  return took;
}

// Lane state and salts of one segment launch (_segment_impl, 2785).  The
// state is planes of n_lanes, row-major: `state` (kSegState, n) f32 of o
// xyz, d xyz, throughput rgb, radiance rgb, alive; `ids` (kSegIds, n) of
// pix, sample, bounce, slot.  Each thread reads and writes only its own
// lane, so the launch updates them in place.  `counts` (kSegCounts, n),
// added to: rays, supers and clusters entered per lane, and in row 3 the
// loop trips of warp w (lanes 32w to 32w + 31) at entry w.
constexpr int kSegState = 13;
constexpr int kSegIds = 4;
constexpr int kSegCounts = 4;

struct SegParams {
  float* state;
  uint32_t* ids;
  int* counts;
  int n_lanes;
  uint32_t frame, max_bounces, k_iters;
  uint32_t rr_start;        // 0 = roulette off
  float rr_floor;
  float clamp;              // 0 = off
};

// One segment for one lane: at most k_iters bounces of the lane's path
// from its stored state, with no raygen and no sample restart, then the
// state back; returns the rays the lane traced.  A dead lane returns at
// once: the per-thread form of the reference's whole-tile early exit
// (after the coherence sort the dead lanes fill whole warps at the back).
// A lane's bounce counter stops at its path's end (the reference's tile
// loop kept counting a dead lane's, which nothing reads).
template <class Isect>
__device__ __forceinline__ int trace_segment(const SegParams& p, int lane,
                                             const Isect& isect) {
  const size_t n = static_cast<size_t>(p.n_lanes);
  float* s = p.state + lane;
  if (!(s[12 * n] > 0.0f)) return 0;
  Path q;
  q.ox = s[0];
  q.oy = s[n];
  q.oz = s[2 * n];
  q.dx = s[3 * n];
  q.dy = s[4 * n];
  q.dz = s[5 * n];
  q.tr = s[6 * n];
  q.tg = s[7 * n];
  q.tb = s[8 * n];
  q.acc_r = s[9 * n];
  q.acc_g = s[10 * n];
  q.acc_b = s[11 * n];
  uint32_t* u = p.ids + lane;
  const uint32_t pix = u[0];
  const uint32_t sample = u[n];
  q.bounce = u[2 * n];
  const uint32_t base = jenkins(pix ^ jenkins(p.frame));
  Counts counts;
  int hint = -1;
  bool alive = true;
  for (uint32_t it = 0; alive && it < p.k_iters; ++it) {
    ++counts.rays;
    alive = bounce_step(p, isect, base, sample, q, counts, hint);
  }
  s[0] = q.ox;
  s[n] = q.oy;
  s[2 * n] = q.oz;
  s[3 * n] = q.dx;
  s[4 * n] = q.dy;
  s[5 * n] = q.dz;
  s[6 * n] = q.tr;
  s[7 * n] = q.tg;
  s[8 * n] = q.tb;
  s[9 * n] = q.acc_r;
  s[10 * n] = q.acc_g;
  s[11 * n] = q.acc_b;
  s[12 * n] = alive ? 1.0f : 0.0f;
  u[2 * n] = q.bounce;
  int* c = p.counts + lane;
  c[0] += counts.rays;
  c[n] += counts.supers;
  c[2 * n] += counts.clusters;
  return counts.rays;
}

// trace_segment with the warp's lanes in step, as trace_warp is for the
// persistent loop: the reference's lockstep tile loop with its whole-tile
// early exit (_segment_impl's cond, pallas_kernels.py:2852), at 32 lanes.
// Every thread of the grid joins its warp's loop, those past n_lanes too.
// A lane is live if it is in range and its stored alive word is above 0;
// only a live lane loads its state.  Each trip, every lane calls
// `isect(live, ...)` once (see trace_warp), and a lane whose path ends is
// live no more; the loop ends when no lane of the warp is live, or after
// k_iters trips.  A lane dead at entry writes nothing; a lane live at
// entry writes back what trace_segment writes, from the same rays in the
// same order.  The warp's trips are the loop's own (the largest ray count
// among its lanes, which trace() reduces in the per-thread form); lane 0
// adds them to the warp's entry of counts row 3.
template <class Isect>
__device__ __forceinline__ void trace_segment_warp(const SegParams& p,
                                                   int lane,
                                                   const Isect& isect) {
  const size_t n = static_cast<size_t>(p.n_lanes);
  const bool in = lane < p.n_lanes;
  float* s = p.state + lane;
  uint32_t* u = p.ids + lane;
  const bool entered = in && s[12 * n] > 0.0f;
  Path q;
  q.ox = 0.0f; q.oy = 0.0f; q.oz = 0.0f;
  q.dx = 0.0f; q.dy = 0.0f; q.dz = 0.0f;
  q.tr = 0.0f; q.tg = 0.0f; q.tb = 0.0f;
  q.acc_r = 0.0f; q.acc_g = 0.0f; q.acc_b = 0.0f;
  q.bounce = 0;
  uint32_t pix = 0, sample = 0;
  if (entered) {
    q.ox = s[0];
    q.oy = s[n];
    q.oz = s[2 * n];
    q.dx = s[3 * n];
    q.dy = s[4 * n];
    q.dz = s[5 * n];
    q.tr = s[6 * n];
    q.tg = s[7 * n];
    q.tb = s[8 * n];
    q.acc_r = s[9 * n];
    q.acc_g = s[10 * n];
    q.acc_b = s[11 * n];
    pix = u[0];
    sample = u[n];
    q.bounce = u[2 * n];
  }
  const uint32_t base = jenkins(pix ^ jenkins(p.frame));
  Counts counts;
  int hint = -1;
  bool live = entered;
  uint32_t it = 0;
  while (__any_sync(kFullMask, live) && it < p.k_iters) {
    Hit h;
    const bool hit = isect(live, q.ox, q.oy, q.oz, q.dx, q.dy, q.dz, h,
                           counts, hint);
    if (live) {
      ++counts.rays;
      live = bounce_finish(p, isect, base, sample, q, hit, h);
    }
    ++it;
  }
  if ((lane & 31) == 0 && it > 0) p.counts[3 * n + (lane >> 5)] += it;
  if (!entered) return;
  s[0] = q.ox;
  s[n] = q.oy;
  s[2 * n] = q.oz;
  s[3 * n] = q.dx;
  s[4 * n] = q.dy;
  s[5 * n] = q.dz;
  s[6 * n] = q.tr;
  s[7 * n] = q.tg;
  s[8 * n] = q.tb;
  s[9 * n] = q.acc_r;
  s[10 * n] = q.acc_g;
  s[11 * n] = q.acc_b;
  s[12 * n] = live ? 1.0f : 0.0f;
  u[2 * n] = q.bounce;
  int* c = p.counts + lane;
  c[0] += counts.rays;
  c[n] += counts.supers;
  c[2 * n] += counts.clusters;
}

// The per-thread body of either launch kind: the persistent loop, or a
// segment.  Every thread of the grid calls it, those past the last lane
// too, so that a segment's warp can reduce over all 32 of its lanes.
template <class Isect>
__device__ __forceinline__ void trace(const LaneParams& p, int lane,
                                      const Isect& isect) {
  if (lane < p.n_lanes) trace_lane(p, lane, isect);
}

// A warp runs its loop until its last lane is done, so its loop trips in
// this launch are the largest ray count among its lanes (the analog of
// the reference's lockstep `niter`, for 32 lanes where a TPU tile held
// 1024).  Lane 0 adds them to the warp's entry of counts row 3; the
// entries are the warp's own, so no atomics.
template <class Isect>
__device__ __forceinline__ void trace(const SegParams& p, int lane,
                                      const Isect& isect) {
  const int rays = lane < p.n_lanes ? trace_segment(p, lane, isect) : 0;
  const int trips = __reduce_max_sync(0xffffffffu, rays);
  if ((lane & 31) == 0 && trips > 0) {
    p.counts[3 * static_cast<size_t>(p.n_lanes) + (lane >> 5)] += trips;
  }
}

// The body of either launch kind with the warp's lanes in step:
// trace_warp for the persistent loop, trace_segment_warp for a segment.
// kProbe's loop bits (kLoopProbes) are the persistent loop's; its
// intersect bits are the intersect's own template argument, so a segment
// reaches them through `isect` alone (fused_segment_* pass the
// reference's PROBE to their intersect only, pallas_kernels.py:3043-3051).
template <int kProbe = 0, class Isect>
__device__ __forceinline__ void trace_in_step(const LaneParams& p, int lane,
                                              const Isect& isect) {
  trace_warp<kProbe>(p, lane, isect);
}

template <int kProbe = 0, class Isect>
__device__ __forceinline__ void trace_in_step(const SegParams& p, int lane,
                                              const Isect& isect) {
  static_assert((kProbe & kLoopProbes) == 0,
                "a segment has no loop probe points (_segment_impl)");
  trace_segment_warp(p, lane, isect);
}

// A ray with its precomputed inverse direction, for box tests.
struct BoxRay {
  float ox, oy, oz, idx, idy, idz;
};

// box_range (pallas_kernels.py:1245-1259): (entry, exit) by the slab
// method.  An axis-parallel ray can give (lo - o) * inf = NaN, which the
// NaN-keeping min/max carry into a false cond, as in the reference.
__device__ __forceinline__ void box_range(const BoxRay& r, float lox,
                                          float loy, float loz, float hix,
                                          float hiy, float hiz, float& tmin,
                                          float& tmax) {
  const float tx0 = (lox - r.ox) * r.idx;
  const float tx1 = (hix - r.ox) * r.idx;
  tmin = nan_min(tx0, tx1);
  tmax = nan_max(tx0, tx1);
  const float ty0 = (loy - r.oy) * r.idy;
  const float ty1 = (hiy - r.oy) * r.idy;
  tmin = nan_max(tmin, nan_min(ty0, ty1));
  tmax = nan_min(tmax, nan_max(ty0, ty1));
  const float tz0 = (loz - r.oz) * r.idz;
  const float tz1 = (hiz - r.oz) * r.idz;
  tmin = nan_max(tmin, nan_min(tz0, tz1));
  tmax = nan_min(tmax, nan_max(tz0, tz1));
}

// Is the ray parallel to an axis (1/d infinite) with its origin on the
// box's face plane on that axis?  Its slab term (lo - o) * inf is NaN.
// NaN padding boxes compare false here.
__device__ __forceinline__ bool on_face(const BoxRay& r, float lox,
                                        float loy, float loz, float hix,
                                        float hiy, float hiz) {
  return (isinf(r.idx) & ((lox == r.ox) | (hix == r.ox))) |
         (isinf(r.idy) & ((loy == r.oy) | (hiy == r.oy))) |
         (isinf(r.idz) & ((loz == r.oz) | (hiz == r.oz)));
}

// cluster_cond (1269-1272): the ray may hit something inside the box
// nearer than `cap`.  A cond made NaN by a ray on a face plane enters,
// whatever the cap: the reference's per-lane cond is false there, and a
// per-ray cull would drop hits on the face that the unculled intersect
// finds (the reference's tile still entered when another lane's cond
// held).
__device__ __forceinline__ bool box_enters(const BoxRay& r, float lox,
                                           float loy, float loz, float hix,
                                           float hiy, float hiz, float cap) {
  float c_min, c_max;
  box_range(r, lox, loy, loz, hix, hiy, hiz, c_min, c_max);
  if (c_min != c_min) return on_face(r, lox, loy, loz, hix, hiy, hiz);
  return (c_min <= c_max) & (c_max > kTMin) & (nan_max(c_min, 0.0f) < cap);
}

// The second evaluation of box conds under a cond probe (kDblCond,
// kDynDblCond): the ray's origin and each cap shifted by an opaque zero,
// so that nvcc recomputes the whole slab test; `dup` is made once a ray.
// A zero's sign can differ from the first evaluation's in a slab term,
// never in a cond.
struct CondDup {
  BoxRay r;
  float z;
};

__device__ __forceinline__ CondDup cond_dup(const BoxRay& r) {
  const float z = opaque_zero();
  return {{r.ox + z, r.oy + z, r.oz + z, r.idx, r.idy, r.idz}, z};
}

// box_enters, and with kDup its second evaluation from `dup`, ANDed (the
// two agree, so the cond is box_enters').
template <bool kDup>
__device__ __forceinline__ bool box_enters_dup(const BoxRay& r,
                                               const CondDup& dup, float lox,
                                               float loy, float loz,
                                               float hix, float hiy,
                                               float hiz, float cap) {
  const bool e = box_enters(r, lox, loy, loz, hix, hiy, hiz, cap);
  if constexpr (kDup) {
    return e & box_enters(dup.r, lox, loy, loz, hix, hiy, hiz, cap + dup.z);
  }
  return e;
}

// slab_exit (1261-1267): the exit from the box that holds a hierarchy
// bounds every hit inside it; a ray that misses the box gets -1, so no
// cluster of it passes its cond.  A ray on a face plane of the box gets
// no bound (kTFar).
__device__ __forceinline__ float slab_exit(const BoxRay& r, float lox,
                                           float loy, float loz, float hix,
                                           float hiy, float hiz) {
  float s_min, s_max;
  box_range(r, lox, loy, loz, hix, hiy, hiz, s_min, s_max);
  if (s_min != s_min) {
    return on_face(r, lox, loy, loz, hix, hiy, hiz) ? kTFar : -1.0f;
  }
  return ((s_min <= s_max) & (s_max > kTMin)) ? s_max : -1.0f;
}

// Triangle rows (ops/bake.py TRI_COLS, five float4): v0 xyz, e1.x |
// e1.y e1.z e2.x e2.y | e2.z, unit normal | albedo rgb, fuzz | ior,
// mat_type, 0, 0.  The pair test reads the first three.
constexpr int kTri = 5;
// A winner index with this bit set is a triangle row.
constexpr int kTriBit = 1 << 30;

// Two-sided Moller-Trumbore (tri_tests, pallas_kernels.py:1191-1210, and
// tri_block, 1926-1943), in their order of operations, over the first
// three float4 of a row (q0-q2, wherever they were read from): t, or
// kTFar where |det| <= 1e-9, the barycentrics leave the triangle or t <=
// T_MIN, and for a NaN padding row.
__device__ __forceinline__ float tri_t(const float4& q0, const float4& q1,
                                       const float4& q2, float ox, float oy,
                                       float oz, float dx, float dy,
                                       float dz) {
  const float e1x = q0.w, e1y = q1.x, e1z = q1.y;
  const float e2x = q1.z, e2y = q1.w, e2z = q2.x;
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool ok = fabsf(det) > 1e-9f;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const float tvx = ox - q0.x;
  const float tvy = oy - q0.y;
  const float tvz = oz - q0.z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
  const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  const bool valid = ok && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f)
      && (tt > kTMin);
  return valid ? tt : kTFar;
}

// tri_t of the row at `row`, read through L1.
__device__ __forceinline__ float tri_test(const float4* __restrict__ row,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz) {
  return tri_t(__ldg(row), __ldg(row + 1), __ldg(row + 2), ox, oy, oz, dx,
               dy, dz);
}

// A triangle winner: its normal and attributes; the sphere fields get
// the miss values (shade reads the normal instead).
__device__ __forceinline__ void fill_tri_hit(const float4* __restrict__ tris,
                                             int i, float t, Hit& h) {
  const float4 q2 = __ldg(tris + kTri * i + 2);
  const float4 q3 = __ldg(tris + kTri * i + 3);
  const float4 q4 = __ldg(tris + kTri * i + 4);
  h.t = t;
  h.cx = 0.0f;
  h.cy = 0.0f;
  h.cz = 0.0f;
  h.inv_r = 1.0f;
  h.ar = q3.x;
  h.ag = q3.y;
  h.ab = q3.z;
  h.fuzz = q3.w;
  h.ior = q4.x;
  h.mt = q4.y;
  h.nx = q2.y;
  h.ny = q2.z;
  h.nz = q2.w;
  h.is_tri = true;
  h.ts = 0.0f;     // a triangle win clears the checker (pallas_kernels.py
  h.slot = -1;     // :791-797, 1231-1234) and never matches an image
}

}  // namespace wpt
