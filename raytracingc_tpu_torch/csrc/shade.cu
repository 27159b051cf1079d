// Resolve, shading and RNG of a bounce, one lane per thread (sm_90a).
//
// Replaces no TPU kernel. On the TPU, XLA fused the integrator's per-lane
// arithmetic (ops/intersect.py resolve_hit, render/integrator.py's bounce
// step, ops/env_light.py, rng.py) into a few fusions; eager PyTorch runs it
// as ~300 elementwise launches a bounce, each over ~20,000 lanes, at a few
// microseconds of device time and ~25 of host time each. This file runs the
// same arithmetic in one launch per call, for the calls through which no
// derivative can flow (ops/shade.py chooses the route):
//
//   * shade_kernel<kBounce>: resolve the search's winner and take the bounce
//     (the integrator's loop: resolve_hit, then the step);
//   * shade_kernel<kPrimary>: the primary resolve of a chunk, with the
//     hit-front's bounce-0 radiance light0;
//   * shade_kernel<kOpen>: the opening scatter of a continuation sample
//     (stream_init, the unit vector, the direction lerp, the roulette draw);
//   * shade_kernel<kStep>: the step on a hit already resolved.
//
// Bit for bit. The kernel reproduces PyTorch's CUDA rounding op by op: the
// same association, no contraction (the library is built with
// --fmad=false), IEEE division and square root, and every value rounded
// where PyTorch rounds it:
//   - a division of a tensor by a Python scalar is a multiply by the
//     scalar's float reciprocal (smoothstep's / (hi - lo));
//   - `1.0 / t` is PyTorch's reciprocal, then * 1.0: the IEEE 1.0f / t;
//   - `a - b` and `c - t` (rsub) are `a + (-1) * b`: the same bits as a - b;
//   - pow takes the float exponent 0.35f and the scene's sun_focus (powf);
//     log, cos and sqrt are logf, cosf and sqrtf, as in PyTorch's kernels;
//   - the uint32 -> float32 conversion rounds to nearest, as PyTorch's
//     int64 -> float32 does for the same value;
//   - clamp and amax keep a NaN, as PyTorch's do.
// The RNG state stays an int64 holding a uint32 (rng.py): uint32 arithmetic
// here gives the low 32 bits that rng.py keeps. Lanes whose value PyTorch
// computes and then discards by a `where` (the unselected branch of the
// resolve, the environment light of a hit) are skipped: no output reads
// them.
//
// What bounds it on an H100: at ~20,000 lanes a bounce call moves ~120
// bytes a lane (pos, d, thr, light, state and the search's winner in; the
// next pos, d, thr, light, state and alive out), ~2.4 MB, 0.7 us at 3.35
// TB/s; its arithmetic (~300 FP32 operations a lane and four transcendental
// calls) is a few microseconds of one SM's issue at most. Its time is the
// launch's. So the design is one launch per call, 256 lanes a CTA, each
// thread reading its [R, 3] rows as three neighbouring floats (a warp's
// loads cover 384 contiguous bytes: whole sectors), and the scene's rows
// gathered from device memory, where the few hundred bytes of a small
// scene's tables stay in L1 and L2. No shared memory, no synchronisation;
// the launch is on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEpsilon = 1e-3f;      // scene/types.py EPSILON
constexpr float kMissDst = 999999.0f;  // scene/types.py MISS_DST
constexpr int kThreads = 256;

// rng.py's constants.
constexpr uint32_t kLcgMul = 747796405u;
constexpr uint32_t kLcgInc = 2891336453u;
constexpr uint32_t kMixMul = 277803737u;
constexpr uint32_t kGamma = 0x9E3779B9u;
constexpr uint32_t kSmM1 = 0x85EBCA6Bu;
constexpr uint32_t kSmM2 = 0xC2B2AE35u;
constexpr uint32_t kRayMul = 0x68BC21EBu;
constexpr uint32_t kSampleMul = 0x2C1B3C6Du;
// float32(1 / (2^32 - 1)) as rng.py rounds it (through the double quotient).
constexpr float kInvU32Max = static_cast<float>(1.0 / 4294967295.0);
constexpr float kTwoPi = static_cast<float>(6.2831853071795864769);

// env_light.py's smoothsteps: (x - lo) * (1.0f / float(hi - lo)).
constexpr float kSkyHi = 0.74f;
constexpr float kGroundLo = -0.01f;
constexpr float kGroundSpan = 0.01f;  // float(0.0 - (-0.01)) in Python

enum Entry { kBounce, kPrimary, kOpen, kStep };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ p, int i) {
  return {p[3 * i + 0], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ void store3(float* __restrict__ p, int i, V3 v) {
  p[3 * i + 0] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 divide(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ V3 pick(bool c, V3 a, V3 b) { return c ? a : b; }
// ops/intersect.py _dot: ((a0 * b0 + a1 * b1) + a2 * b2).
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
// torch.clamp_min / torch.clamp with scalar bounds: a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}
// amax over three channels (NaN-propagating; the sign of a zero maximum
// does not matter: p is read by p > 0 and p >= u only).
__device__ __forceinline__ float amax(V3 v) {
  float m = v.x;
  m = (isnan(m) || m >= v.y) ? m : v.y;
  m = (isnan(m) || m >= v.z) ? m : v.z;
  return m;
}

// --- The scene's tables (scene/types.py), as the scene holds them. --------

struct SceneTables {
  const float* a;           // [T, 3]
  const float* b;           // [T, 3]
  const float* c;           // [T, 3]
  const float* normal;      // [T, 3]
  const float* albedo;      // [T, 3]
  const float* emission;    // [T]
  const float* smoothness;  // [T]
  const float* perm_rows;   // [T, 17] Morton-permuted resolve table, or null
  const int32_t* perm_of_orig;  // [T] original index -> permuted slot
  int n_rows;               // T
  const float* s_center;    // [S, 3]
  const float* s_radius;    // [S]
  const float* s_albedo;    // [S, 3]
  const float* s_emission;  // [S]
  const float* s_smoothness;  // [S]
  const float* sun_direction;  // [3]
  const float* sky_horizon;    // [3]
  const float* sky_zenith;     // [3]
  const float* ground;         // [3]
  const float* sun_focus;      // scalar
  const float* sun_intensity;  // scalar
};

struct Hit {
  bool hit;
  float dst;
  V3 point, normal, albedo;
  float emission, smoothness;
};

// ops/intersect.py resolve_hit for one lane: the winner's geometry and
// material, the distance recomputed by Moller-Trumbore (triangles) or the
// quadratic (spheres). Only the selected branch is computed.
__device__ Hit resolve(V3 o, V3 d, bool hit, bool is_tri, int idx,
                       const SceneTables& s) {
  Hit h;
  h.hit = hit;
  if (hit && is_tri) {
    V3 a, b, c;
    if (s.perm_rows != nullptr) {  // ops/intersect.py with_perm_resolve
      const float* row = s.perm_rows + 17 * static_cast<int64_t>(
          s.perm_of_orig[min(idx, s.n_rows - 1)]);
      a = {row[0], row[1], row[2]};
      b = {row[3], row[4], row[5]};
      c = {row[6], row[7], row[8]};
      h.normal = {row[9], row[10], row[11]};
      h.albedo = {row[12], row[13], row[14]};
      h.emission = row[15];
      h.smoothness = row[16];
    } else {
      a = load3(s.a, idx);
      b = load3(s.b, idx);
      c = load3(s.c, idx);
      h.normal = load3(s.normal, idx);
      h.albedo = load3(s.albedo, idx);
      h.emission = s.emission[idx];
      h.smoothness = s.smoothness[idx];
    }
    const V3 ab = sub(b, a);
    const V3 ac = sub(c, a);
    const V3 hv = cross(d, ac);
    const float det = dot(ab, hv);
    const float inv_det = 1.0f / (fabsf(det) < kEpsilon ? 1.0f : det);
    const V3 q = cross(sub(o, a), ab);
    h.dst = dot(ac, q) * inv_det;
    h.point = add(o, scale(d, h.dst));
  } else if (hit) {
    const V3 center = load3(s.s_center, idx);
    const float radius = s.s_radius[idx];
    const float safe_radius = radius > 0.0f ? radius : 1.0f;
    const V3 offset = sub(o, center);
    const float bq = dot(offset, d);
    const float delta = bq * bq - (dot(offset, offset) - safe_radius * safe_radius);
    const float sq = sqrtf(clamp_min(delta, 1e-20f));
    const float near_root = -bq - sq;
    h.dst = near_root < kEpsilon ? -bq + sq : near_root;
    h.point = add(o, scale(d, h.dst));
    h.normal = divide(sub(h.point, center), safe_radius);
    h.albedo = load3(s.s_albedo, idx);
    h.emission = s.s_emission[idx];
    h.smoothness = s.s_smoothness[idx];
  } else {
    h.dst = kMissDst;
    h.point = add(o, scale(d, kMissDst));  // computed on a miss, as the C code does
    h.normal = {0.0f, 0.0f, 0.0f};
    h.albedo = {0.0f, 0.0f, 0.0f};
    h.emission = 0.0f;
    h.smoothness = 0.0f;
  }
  return h;
}

// --- rng.py ---------------------------------------------------------------

__device__ __forceinline__ uint32_t splitmix(uint32_t x) {
  x = (x ^ (x >> 16)) * kSmM1;
  x = (x ^ (x >> 13)) * kSmM2;
  return x ^ (x >> 16);
}

// stream_init, given s0 = splitmix(seed + GAMMA) from the host.
__device__ __forceinline__ uint32_t stream_init(uint32_t s0, uint32_t ray_id,
                                                uint32_t sample_id) {
  const uint32_t s = splitmix(s0 ^ (ray_id * kRayMul + kGamma));
  return splitmix(s ^ (sample_id * kSampleMul + kGamma));
}

__device__ __forceinline__ float next_uniform(uint32_t& state) {
  state = state * kLcgMul + kLcgInc;
  uint32_t r = ((state >> ((state >> 28) + 4)) ^ state) * kMixMul;
  r = (r >> 22) ^ r;
  return static_cast<float>(r) * kInvU32Max;
}

// Box-Muller: sqrt(log(max(u2, 1e-10)) * -2) * cos(u1 * 2 pi).
__device__ __forceinline__ float next_normal(uint32_t& state) {
  const float u1 = next_uniform(state);
  const float u2 = clamp_min(next_uniform(state), 1e-10f);
  return sqrtf(logf(u2) * -2.0f) * cosf(u1 * kTwoPi);
}

__device__ __forceinline__ V3 normalize(V3 v) {
  const float norm = sqrtf(v.x * v.x + v.y * v.y + v.z * v.z);
  return divide(v, clamp_min(norm, 1e-12f));
}

// next_unit_vector: three normals (six draws), normalized.
__device__ __forceinline__ V3 next_unit_vector(uint32_t& state) {
  const float x = next_normal(state);
  const float y = next_normal(state);
  const float z = next_normal(state);
  return normalize({x, y, z});
}

// --- The scatter (render/integrator.py) and the sky (ops/env_light.py). ---

// lerp(normalize(normal + unit), specular, smoothness):
// (1 - s) * diffuse + s * specular.
__device__ __forceinline__ V3 scatter(V3 normal, V3 unit, V3 specular, float s) {
  const V3 diffuse = normalize(add(normal, unit));
  const float keep = 1.0f - s;
  return add(scale(diffuse, keep), scale(specular, s));
}

// d - (2 * (d . n)) * n.
__device__ __forceinline__ V3 reflect(V3 d, V3 n) {
  const float twice = 2.0f * dot(d, n);
  return sub(d, scale(n, twice));
}

__device__ __forceinline__ float smoothstep(float x, float lo, float inv_span) {
  const float t = clamp01((x - lo) * inv_span);
  return t * t * (3.0f - 2.0f * t);
}

// x ** p for x > 0, else 0 (env_light.py _safe_pow).
__device__ __forceinline__ float safe_pow(float x, float p) {
  return x > 0.0f ? powf(x, p) : 0.0f;
}

__device__ V3 environment_light(V3 d, const SceneTables& s) {
  const float up = -d.y;
  const float sky_t = safe_pow(smoothstep(up, 0.0f, 1.0f / kSkyHi), 0.35f);
  const float sky_keep = 1.0f - sky_t;
  const V3 sky = add(scale(load3(s.sky_horizon, 0), sky_keep),
                     scale(load3(s.sky_zenith, 0), sky_t));
  const V3 sd = load3(s.sun_direction, 0);
  const float cos_sun = clamp_min(d.x * sd.x + d.y * sd.y + d.z * sd.z, 0.0f);
  float sun = safe_pow(cos_sun, *s.sun_focus) * *s.sun_intensity;
  sun = d.y < 0.0f ? sun : 0.0f;
  const float ground_t = smoothstep(up, kGroundLo, 1.0f / kGroundSpan);
  const float ground_keep = 1.0f - ground_t;
  const V3 mixed = add(scale(load3(s.ground, 0), ground_keep), scale(sky, ground_t));
  return {mixed.x + sun, mixed.y + sun, mixed.z + sun};
}

// --- The four entries' lanes. ---------------------------------------------

struct Lanes {
  // Inputs (null where the entry takes none).
  const float* pos;    // [R, 3] ray origins
  const float* dir;    // [R, 3]
  const float* thr;    // [R, 3]
  const float* light;  // [R, 3]
  const int64_t* state;  // [R] uint32 in int64
  const bool* hit;     // [R] the search's winner, or the resolved hit's flag
  const bool* is_tri;  // [R]
  const int32_t* idx;  // [R]
  const bool* alive;   // [R] or null: every lane alive
  const float* h_point;  // [R, 3] a resolved hit (kStep)
  const float* h_normal;
  const float* h_albedo;
  const float* h_emission;  // [R]
  const float* h_smoothness;
  const int64_t* ray_id;    // [R] (kOpen)
  const int64_t* sample_id;  // [R] or null: sample0 for every lane
  const float* spec;   // [R, 3] (kOpen)
  const float* p;      // [R] (kOpen) roulette's survival probability
  // Outputs.
  float* o_pos;
  float* o_dir;
  float* o_thr;
  float* o_light;
  int64_t* o_state;
  bool* o_alive;
  float* o_dst;  // kPrimary
  float* o_normal;
  float* o_albedo;
  float* o_emission;
  float* o_smoothness;
  int n;
  uint32_t s0;       // kOpen: splitmix(seed + GAMMA)
  uint32_t sample0;  // kOpen
};

// render/integrator.py's step: scatter, emission, roulette and miss.
__device__ void step(const Lanes& L, const SceneTables& s, int i, const Hit& h) {
  const V3 pos = load3(L.pos, i);
  const V3 d = load3(L.dir, i);
  const V3 thr = load3(L.thr, i);
  V3 light = load3(L.light, i);
  uint32_t state = static_cast<uint32_t>(L.state[i]);
  const bool alive = L.alive == nullptr || L.alive[i];

  const V3 unit = next_unit_vector(state);
  const V3 new_dir = scatter(h.normal, unit, reflect(d, h.normal), h.smoothness);

  const bool live_hit = alive && h.hit;
  const bool live_miss = alive && !h.hit;
  // Emission weighted by the pre-update throughput, then albedo.
  const V3 zero{0.0f, 0.0f, 0.0f};
  const V3 emitted = scale(h.albedo, h.emission);
  light = add(light, live_hit ? mul(emitted, thr) : zero);
  V3 new_thr = mul(thr, h.albedo);

  // Russian roulette: survive iff p >= u.
  const float u_rr = next_uniform(state);
  const float p = amax(new_thr);
  const bool survive = p >= u_rr;
  new_thr = divide(new_thr, p > 0.0f ? p : 1.0f);

  // Miss: the environment light, and the path ends.
  light = add(light, live_miss ? mul(environment_light(d, s), thr) : zero);

  store3(L.o_thr, i, pick(live_hit, new_thr, thr));
  store3(L.o_pos, i, pick(live_hit, h.point, pos));
  store3(L.o_dir, i, pick(live_hit, new_dir, d));
  store3(L.o_light, i, light);
  L.o_state[i] = static_cast<int64_t>(state);
  L.o_alive[i] = live_hit && survive;
}

template <Entry kEntry>
__global__ void __launch_bounds__(kThreads)
shade_kernel(const Lanes L, const SceneTables s) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= L.n) return;
  if constexpr (kEntry == kBounce) {
    const Hit h = resolve(load3(L.pos, i), load3(L.dir, i), L.hit[i], L.is_tri[i],
                          L.idx[i], s);
    step(L, s, i, h);
  } else if constexpr (kEntry == kStep) {
    Hit h;
    h.hit = L.hit[i];
    h.point = load3(L.h_point, i);
    h.normal = load3(L.h_normal, i);
    h.albedo = load3(L.h_albedo, i);
    h.emission = L.h_emission[i];
    h.smoothness = L.h_smoothness[i];
    step(L, s, i, h);
  } else if constexpr (kEntry == kPrimary) {
    // The Hit of the primary rays, and the hit-front's bounce-0 radiance:
    // emission on live hits, the environment light on live misses.
    const V3 o = load3(L.pos, i);
    const V3 d = load3(L.dir, i);
    const Hit h = resolve(o, d, L.hit[i], L.is_tri[i], L.idx[i], s);
    L.o_dst[i] = h.dst;
    store3(L.o_pos, i, h.point);
    store3(L.o_normal, i, h.normal);
    store3(L.o_albedo, i, h.albedo);
    L.o_emission[i] = h.emission;
    L.o_smoothness[i] = h.smoothness;
    const bool act = L.alive[i];
    const V3 zero{0.0f, 0.0f, 0.0f};
    const V3 emitted = act && h.hit ? scale(h.albedo, h.emission) : zero;
    const V3 env = act && !h.hit ? environment_light(d, s) : zero;
    store3(L.o_light, i, add(emitted, env));
  } else {  // kOpen
    const uint32_t sample = L.sample_id == nullptr
        ? L.sample0 : static_cast<uint32_t>(L.sample_id[i]);
    uint32_t state = stream_init(L.s0, static_cast<uint32_t>(L.ray_id[i]), sample);
    const V3 unit = next_unit_vector(state);
    store3(L.o_dir, i, scatter(load3(L.h_normal, i), unit, load3(L.spec, i),
                               L.h_smoothness[i]));
    const float u_rr = next_uniform(state);
    L.o_state[i] = static_cast<int64_t>(state);
    L.o_alive[i] = L.p[i] >= u_rr;
  }
}

SceneTables scene_tables(const void* const* t, int n_rows) {
  auto f = [t](int k) { return static_cast<const float*>(t[k]); };
  return {f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7),
          static_cast<const int32_t*>(t[8]), n_rows,
          f(9), f(10), f(11), f(12), f(13),
          f(14), f(15), f(16), f(17), f(18), f(19)};
}

template <Entry kEntry>
int launch(const Lanes& lanes, const SceneTables& tables, void* stream) {
  if (lanes.n > 0) {
    const int blocks = (lanes.n + kThreads - 1) / kThreads;
    shade_kernel<kEntry><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        lanes, tables);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches on `stream` (nothing when n == 0) and returns
// cudaGetLastError() as an int (0 = launched). `scene` is a host array of
// the scene's 20 device pointers (scene_tables above; ops/shade.py
// _scene_args), `n_rows` its triangle rows. [R] and [R, 3] arrays are
// contiguous; `alive` may be null (every lane alive).

// The loop's bounce: resolve the winner (hit, is_tri, idx), then the step.
int rtc_shade_bounce(const void* const* scene, int n_rows, const void* pos,
                     const void* dir, const void* thr, const void* light,
                     const void* state, const void* hit, const void* is_tri,
                     const void* idx, const void* alive, int n, void* o_pos,
                     void* o_dir, void* o_thr, void* o_light, void* o_state,
                     void* o_alive, void* stream) {
  Lanes L{};
  L.pos = static_cast<const float*>(pos);
  L.dir = static_cast<const float*>(dir);
  L.thr = static_cast<const float*>(thr);
  L.light = static_cast<const float*>(light);
  L.state = static_cast<const int64_t*>(state);
  L.hit = static_cast<const bool*>(hit);
  L.is_tri = static_cast<const bool*>(is_tri);
  L.idx = static_cast<const int32_t*>(idx);
  L.alive = static_cast<const bool*>(alive);
  L.o_pos = static_cast<float*>(o_pos);
  L.o_dir = static_cast<float*>(o_dir);
  L.o_thr = static_cast<float*>(o_thr);
  L.o_light = static_cast<float*>(o_light);
  L.o_state = static_cast<int64_t*>(o_state);
  L.o_alive = static_cast<bool*>(o_alive);
  L.n = n;
  return launch<kBounce>(L, scene_tables(scene, n_rows), stream);
}

// The step on a resolved hit (hit, point, normal, albedo, emission,
// smoothness).
int rtc_shade_step(const void* const* scene, int n_rows, const void* pos,
                   const void* dir, const void* thr, const void* light,
                   const void* state, const void* hit, const void* point,
                   const void* normal, const void* albedo, const void* emission,
                   const void* smoothness, const void* alive, int n, void* o_pos,
                   void* o_dir, void* o_thr, void* o_light, void* o_state,
                   void* o_alive, void* stream) {
  Lanes L{};
  L.pos = static_cast<const float*>(pos);
  L.dir = static_cast<const float*>(dir);
  L.thr = static_cast<const float*>(thr);
  L.light = static_cast<const float*>(light);
  L.state = static_cast<const int64_t*>(state);
  L.hit = static_cast<const bool*>(hit);
  L.h_point = static_cast<const float*>(point);
  L.h_normal = static_cast<const float*>(normal);
  L.h_albedo = static_cast<const float*>(albedo);
  L.h_emission = static_cast<const float*>(emission);
  L.h_smoothness = static_cast<const float*>(smoothness);
  L.alive = static_cast<const bool*>(alive);
  L.o_pos = static_cast<float*>(o_pos);
  L.o_dir = static_cast<float*>(o_dir);
  L.o_thr = static_cast<float*>(o_thr);
  L.o_light = static_cast<float*>(o_light);
  L.o_state = static_cast<int64_t*>(o_state);
  L.o_alive = static_cast<bool*>(o_alive);
  L.n = n;
  return launch<kStep>(L, scene_tables(scene, n_rows), stream);
}

// The primary resolve: the Hit fields (dst, point, normal, albedo,
// emission, smoothness) and light0 over the lanes `act` (never null).
int rtc_shade_primary(const void* const* scene, int n_rows, const void* o,
                      const void* d, const void* hit, const void* is_tri,
                      const void* idx, const void* act, int n, void* o_dst,
                      void* o_point, void* o_normal, void* o_albedo,
                      void* o_emission, void* o_smoothness, void* o_light0,
                      void* stream) {
  Lanes L{};
  L.pos = static_cast<const float*>(o);
  L.dir = static_cast<const float*>(d);
  L.hit = static_cast<const bool*>(hit);
  L.is_tri = static_cast<const bool*>(is_tri);
  L.idx = static_cast<const int32_t*>(idx);
  L.alive = static_cast<const bool*>(act);
  L.o_dst = static_cast<float*>(o_dst);
  L.o_pos = static_cast<float*>(o_point);
  L.o_normal = static_cast<float*>(o_normal);
  L.o_albedo = static_cast<float*>(o_albedo);
  L.o_emission = static_cast<float*>(o_emission);
  L.o_smoothness = static_cast<float*>(o_smoothness);
  L.o_light = static_cast<float*>(o_light0);
  L.n = n;
  return launch<kPrimary>(L, scene_tables(scene, n_rows), stream);
}

// The opening scatter of a continuation sample: each lane's stream from
// (s0, ray_id, sample id: sample_id[i], or sample0 where it is null), the
// unit vector, the direction lerp, then the roulette draw against p.
int rtc_shade_open(unsigned s0, const void* ray_id, const void* sample_id,
                   unsigned sample0, const void* normal, const void* smoothness,
                   const void* spec, const void* p, int n, void* o_state,
                   void* o_dir, void* o_survive, void* stream) {
  Lanes L{};
  L.s0 = s0;
  L.ray_id = static_cast<const int64_t*>(ray_id);
  L.sample_id = static_cast<const int64_t*>(sample_id);
  L.sample0 = sample0;
  L.h_normal = static_cast<const float*>(normal);
  L.h_smoothness = static_cast<const float*>(smoothness);
  L.spec = static_cast<const float*>(spec);
  L.p = static_cast<const float*>(p);
  L.o_state = static_cast<int64_t*>(o_state);
  L.o_dir = static_cast<float*>(o_dir);
  L.o_alive = static_cast<bool*>(o_survive);
  L.n = n;
  return launch<kOpen>(L, SceneTables{}, stream);
}

}  // extern "C"
