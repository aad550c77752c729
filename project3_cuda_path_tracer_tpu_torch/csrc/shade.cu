// S1: one scattering step of the wavefront without a gradient, the whole of
// ops/wavefront.shade_planar for the features it covers: the albedo (the
// material colour, the fused table's atlas texel, the procedural checker),
// the emissive and miss radiance (the constant env or the fused table's
// RGBE env texel), under area-light NEE the MIS weight of an emissive hit,
// the direct term and the lobe's pdf `nee_pdf`, the lobe choice, the
// cosine-hemisphere, mirror and Fresnel/TIR refraction directions, the
// throughput factor, the new origin with the transmit push, and the lanes
// still alive.
//
// Replaces no Pallas kernel: the JAX package leaves shading to XLA's fusion
// of jnp. In the port that chain is ~270-360 torch kernels a bounce, each
// reading and writing whole [N] planes (PERF.md section 5), where a lane's
// step needs its hit record, ray, throughput and draws in and its new ray,
// throughput, radiance and flag out.
//
// What bounds it on this card: memory traffic. A lane reads 98 B (t, the
// normal, an int64 material, the backed-off and exact points, the uv, the
// outside flag, the ray's direction, the throughput, the alive flag, four
// draws) and writes 49 B (origin, direction, throughput, radiance, alive);
// NEE reads 33 B more (the light sample, its flag, its pdf, the previous
// lobe's pdf) and writes 4 (`nee_pdf`); the fused texel adds a 4-byte word
// in. ~147 B a mesh.txt lane, 46 us at 1,048,576 lanes and 3.35 TB/s. The
// design:
//   - One thread owns one lane and runs the whole step in registers; each
//     output plane is written once, coalesced.
//   - A material's row is the same for every lane: the block stages the
//     rows (colour, specular colour, emittance, the lobe probabilities, the
//     ior, the checker, the atlas rect and texture id) in shared memory, in
//     place of the chain's per-lane gathers. A table of more than
//     MAX_MATERIALS rows is not staged: each lane reads its own row from
//     the tables in global memory (the STAGED switch, picked at launch).
//   - Two compile-time switches: NEE (area-light MIS) and TEX (the fused
//     nearest atlas+env texel). Under TEX a bounce is three launches:
//     shade_index_kernel computes each lane's index into the fused table
//     (the atlas texel on hit lanes, Ha*Wa + the env texel on miss lanes),
//     P1 (csrc/gather.cu) fetches the words, and shade_kernel decodes them.
//   - Bit for bit with the torch chain on the card: every float operation
//     is one IEEE-rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
//     __fdiv_rn, so that nvcc's default contraction cannot fuse a pair), in
//     the chain's order (vec.dot's and vec.cross's left-to-right terms); a
//     division by a Python float as ATen computes it on CUDA, a product
//     with the float reciprocal; `1.0 / x` as the reciprocal; a product
//     with a Python float as one with that float rounded to float32; the
//     libdevice functions ATen's kernels call (sqrtf, rsqrtf, cosf, sinf,
//     atan2f, acosf, floorf, fmodf); torch.minimum / maximum's and clamp's
//     NaN propagation; float-to-int conversions that truncate.
//   - No atomics: the launch tally is one thread's increment, ordered by
//     the stream.
//
// Interface (plain C, bound with ctypes by ops/shade.py):
//   shade_launch(nee, tex, n, in [PLANES], strides [PLANES] (elements; 0
//     broadcasts one value), mats [TABLES], m, env (the constant env's
//     texel, 3 f32, null under tex), scale ([] f32, env_enabled), nee_area,
//     last (whether this is the last bounce), out [OUT_FLOATS] f32
//     planes (out[OPDF] null without nee), out_alive [n] u8, launches or
//     null, stream) -> cudaError_t.
//   shade_index_launch(n, in, strides, mats, m, ha, wa, he, we, out [n]
//     i32, launches or null, stream) -> cudaError_t: reads in[T_], in[U_],
//     in[V_], in[DX..DZ] and in[MATID].
//   The input planes are ops/shade.IN_PLANES in that order: the float
//   planes, then the int64 material, the u8 flags (outside, alive, the
//   light's visibility) and the int32 texel word; the
//   tables ops/shade.TABLES; the outputs ops/shade.OUT_PLANES.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// the input planes (ops/shade.IN_PLANES)
enum : int {
  T_, NX, NY, NZ, PX, PY, PZ, SX, SY, SZ, U_, V_, DX, DY, DZ, THX, THY, THZ,
  UL, U1, U2, UF, WLX, WLY, WLZ, LEX, LEY, LEZ, PDFL, PREV,
  MATID, OUTSIDE, ALIVE, VIS, TEXEL, PLANES
};
// the output planes (ops/shade.OUT_PLANES; alive apart, u8)
enum : int {
  OX, OY, OZ, ODX, ODY, ODZ, OTX, OTY, OTZ, ORX, ORY, ORZ, OPDF, OUT_FLOATS
};
// the material tables (ops/shade.TABLES): f32 [M,3], [M,3], [M] x 5, [M,3],
// then i32 [M,4], [M]
enum : int {
  MCOLOR, MSPEC, MEMIT, MREFR, MREFL, MIOR, MCS, MC2, MRECT, MTID, TABLES
};
// a staged material row: colour 0-2, specular colour 3-5, emittance 6,
// refraction 7, reflection 8, ior 9, checker scale 10, checker colour 11-13,
// atlas rect 14-17 and texture id 18 as float32 (the chain's `.to(F32)`)
constexpr int ROW = 19;
// the most rows one block stages in shared memory (38,912 B)
constexpr int MAX_MATERIALS = 512;

// the chain's Python floats as ATen takes them: rounded to float32
constexpr float SQRT_THIRD = static_cast<float>(0.5773502691896257645);
constexpr float TWO_PI_F = static_cast<float>(6.2831853071795864769);
constexpr float PI_F = static_cast<float>(3.141592653589793);
constexpr float INV_PI_F = static_cast<float>(1.0 / 3.141592653589793);
constexpr float PUSH = static_cast<float>(2.0 * 1e-4);  // 2 * RAY_EPS
constexpr float D2_FLOOR = static_cast<float>(1e-12);
constexpr float TINY_DIV = static_cast<float>(1e-30);
constexpr float P_FLOOR = static_cast<float>(1e-6);
constexpr float COS_FLOOR = static_cast<float>(1e-20);
constexpr float AREA_FLOOR = static_cast<float>(1e-9);

struct Params {
  const void* in[PLANES];
  long long stride[PLANES];
  const void* mats[TABLES];
  int m;
  const float* env;
  const float* scale;
  float nee_area;
  int last;
  int ha, wa, he, we;
  long long n;
  float* out[OUT_FLOATS];
  unsigned char* out_alive;
  int* out_index;
  unsigned long long* launches;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}

// torch.minimum / torch.maximum on CUDA: a NaN operand (the first one
// first) is returned as it is, else fminf / fmaxf; torch.clamp with a
// scalar bound passes a NaN value through, which is the same
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return tmin(tmax(x, lo), hi);
}

// torch.remainder on CUDA floats: fmod, moved into the divisor's sign
__device__ __forceinline__ float remainder(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.f && ((b < 0.f) != (r < 0.f))) r = add(r, b);
  return r;
}

__device__ __forceinline__ float dot(float ax, float ay, float az, float bx,
                                     float by, float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

// vec.normalize: a * rsqrt(d2 > 1e-12 ? d2 : 1)
__device__ __forceinline__ void normalize(float& x, float& y, float& z) {
  const float d2 = dot(x, y, z, x, y, z);
  const float s = rsqrtf(d2 > D2_FLOOR ? d2 : 1.0f);
  x = mul(x, s);
  y = mul(y, s);
  z = mul(z, s);
}

// vec.cross(a, b) into a
__device__ __forceinline__ void cross(float ax, float ay, float az, float bx,
                                      float by, float bz, float& cx,
                                      float& cy, float& cz) {
  cx = sub(mul(ay, bz), mul(az, by));
  cy = sub(mul(az, bx), mul(ax, bz));
  cz = sub(mul(ax, by), mul(ay, bx));
}

__device__ __forceinline__ float ldf(const Params& p, int k, long long i) {
  return __ldg(static_cast<const float*>(p.in[k]) + i * p.stride[k]);
}
__device__ __forceinline__ bool ldb(const Params& p, int k, long long i) {
  return __ldg(static_cast<const unsigned char*>(p.in[k]) + i * p.stride[k])
         != 0;
}

// the lane's material (an id outside the table reads row 0 or M-1: the
// chain's gather would fault)
__device__ __forceinline__ int material(const Params& p, long long i) {
  const long long mid = __ldg(static_cast<const long long*>(p.in[MATID]) +
                              i * p.stride[MATID]);
  return static_cast<int>(mid < 0 ? 0 : mid >= p.m ? p.m - 1 : mid);
}

// material m's row r from the tables in global memory
__device__ __forceinline__ void load_row(const Params& p, int m, float* r) {
  const float* color = static_cast<const float*>(p.mats[MCOLOR]);
  const float* spec = static_cast<const float*>(p.mats[MSPEC]);
  const float* c2 = static_cast<const float*>(p.mats[MC2]);
  const int* rect = static_cast<const int*>(p.mats[MRECT]);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r[c] = __ldg(color + 3 * m + c);
    r[3 + c] = __ldg(spec + 3 * m + c);
    r[11 + c] = __ldg(c2 + 3 * m + c);
  }
  r[6] = __ldg(static_cast<const float*>(p.mats[MEMIT]) + m);
  r[7] = __ldg(static_cast<const float*>(p.mats[MREFR]) + m);
  r[8] = __ldg(static_cast<const float*>(p.mats[MREFL]) + m);
  r[9] = __ldg(static_cast<const float*>(p.mats[MIOR]) + m);
  r[10] = __ldg(static_cast<const float*>(p.mats[MCS]) + m);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    r[14 + c] = static_cast<float>(__ldg(rect + 4 * m + c));
  r[18] = static_cast<float>(__ldg(static_cast<const int*>(p.mats[MTID]) + m));
}

// _unpack_rgb8: channel c = byte c / 255.0, a product with 1/255 in float32
__device__ __forceinline__ void unpack_rgb8(int q, float* rgb) {
  const float inv = dvd(1.0f, 255.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    rgb[c] = mul(static_cast<float>((q >> (8 * c)) & 0xFF), inv);
}

// _unpack_rgbe: (m + 0.5) * (2^(E-136), built from its bits, or 0) * scale
__device__ __forceinline__ void unpack_rgbe(int q, float scale, float* rgb) {
  const int ex = (q >> 24) & 0xFF;
  int b = ex - 9;
  b = b < 1 ? 1 : b > 254 ? 254 : b;
  const float s = mul(ex > 0 ? __int_as_float(b << 23) : 0.0f, scale);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    rgb[c] = mul(add(static_cast<float>((q >> (8 * c)) & 0xFF), 0.5f), s);
}

// The lane's index into the fused atlas+env table (_textured_albedo's
// fused branch): _atlas_flat_index on hit lanes, _env_flat_index + Ha*Wa
// on miss lanes (t <= 0).
__device__ __forceinline__ int fused_index(const Params& p, const float* mat,
                                           long long i) {
  const float t = ldf(p, T_, i);
  const float u = ldf(p, U_, i), v = ldf(p, V_, i);
  const float rx = mat[14], ry = mat[15], rw = mat[16], rh = mat[17];
  const float uu = sub(u, floorf(u));
  const float vv = sub(v, floorf(v));
  // _between(x, 0, hi): clamp(min=0), then torch.minimum
  const float xi =
      add(rx, tmin(tmax(floorf(mul(uu, rw)), 0.f), tmax(sub(rw, 1.f), 0.f)));
  const float yi = add(ry, tmin(tmax(floorf(mul(sub(1.f, vv), rh)), 0.f),
                                tmax(sub(rh, 1.f), 0.f)));
  const int aflat = static_cast<int>(
      add(mul(clip(yi, 0.f, static_cast<float>(p.ha - 1)),
              static_cast<float>(p.wa)),
          clip(xi, 0.f, static_cast<float>(p.wa - 1))));
  if (!(t <= 0.f)) return aflat;
  const float dx = ldf(p, DX, i), dy = ldf(p, DY, i), dz = ldf(p, DZ, i);
  // `/ (2.0 * math.pi)` and `/ math.pi`: products with the reciprocals
  const float ue = add(mul(atan2f(dx, -dz), dvd(1.0f, TWO_PI_F)), 0.5f);
  const float ve = mul(acosf(clip(dy, -1.f, 1.f)), dvd(1.0f, PI_F));
  int xe = static_cast<int>(mul(ue, static_cast<float>(p.we)));
  int ye = static_cast<int>(mul(ve, static_cast<float>(p.he)));
  xe = min(max(xe, 0), p.we - 1);
  ye = min(max(ye, 0), p.he - 1);
  return ye * p.we + xe + p.ha * p.wa;
}

// One lane of shade_planar (glossy, sky, bump, nmap, bilinear and
// dispersion off; NEE: area lights alone, nee_q = 1).
template <bool NEE, bool TEX>
__device__ __forceinline__ void shade_lane(const Params& p, const float* mat,
                                           long long i) {
  const float t = ldf(p, T_, i);
  const float nx = ldf(p, NX, i), ny = ldf(p, NY, i), nz = ldf(p, NZ, i);
  const float dx = ldf(p, DX, i), dy = ldf(p, DY, i), dz = ldf(p, DZ, i);
  const float u = ldf(p, U_, i), v = ldf(p, V_, i);
  float th[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) th[c] = ldf(p, THX + c, i);
  const bool alive = ldb(p, ALIVE, i);
  const bool outside = ldb(p, OUTSIDE, i);
  const bool last = p.last != 0;

  // the albedo: colour, texel, checker; the env radiance of a miss
  float al[3] = {mat[0], mat[1], mat[2]};
  float en[3];
  const float scale = __ldg(p.scale);
  if (TEX) {
    const int q = __ldg(static_cast<const int*>(p.in[TEXEL]) +
                        i * p.stride[TEXEL]);
    if (mat[18] >= 0.f && !(t <= 0.f)) unpack_rgb8(q, al);
    unpack_rgbe(q, scale, en);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) en[c] = mul(__ldg(p.env + c), scale);
  }
  const float cs = mat[10];
  const float par =
      remainder(add(floorf(mul(u, cs)), floorf(mul(v, cs))), 2.0f);
  if (cs > 0.f && par > 0.5f) {
    al[0] = mat[11];
    al[1] = mat[12];
    al[2] = mat[13];
  }
  const float emit = mat[6];
  const float p_refr = clip(mat[7], 0.f, 1.f);
  const float p_spec = mul(clip(mat[8], 0.f, 1.f), sub(1.f, p_refr));
  const float p_diff = tmax(sub(sub(1.f, p_refr), p_spec), 0.f);
  const float ior = mat[9];

  const bool hit_ok = t > 0.f;
  const bool is_light = hit_ok && emit > 0.f;
  const bool lit = alive && is_light;
  const bool mis = alive && !hit_ok;
  float rad_scale = lit ? emit : 0.f;
  if (NEE) {
    // the MIS weight of an emissive hit against the area sampler
    const float prev = ldf(p, PREV, i);
    const float cos_l_hit = fabsf(dot(nx, ny, nz, dx, dy, dz));
    const float pdf_l_hit =
        dvd(mul(t, t), tmax(mul(cos_l_hit, p.nee_area), AREA_FLOOR));
    const float w_hit =
        prev > 0.f ? dvd(prev, tmax(add(prev, pdf_l_hit), TINY_DIV)) : 1.f;
    rad_scale = mul(rad_scale, w_hit);
  }
  float rad[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    rad[c] = lit ? mul(mul(th[c], al[c]), rad_scale)
                 : mis ? mul(th[c], en[c]) : 0.f;

  const float u_lobe = ldf(p, UL, i);
  const bool take_refr = u_lobe < p_refr;
  const bool take_spec = !take_refr && u_lobe < add(p_refr, p_spec);

  // the diffuse lobe: cosine_hemisphere_planar
  float ddx, ddy, ddz;
  {
    const float u1 = ldf(p, U1, i), u2 = ldf(p, U2, i);
    const float up = sqrtf(u1);
    const float over = sqrtf(tmax(sub(1.f, u1), 0.f));
    const float around = mul(u2, TWO_PI_F);
    const bool pick_x = fabsf(nx) < SQRT_THIRD;
    const bool pick_y = !pick_x && fabsf(ny) < SQRT_THIRD;
    const float ax = pick_x ? 1.f : 0.f, ay = pick_y ? 1.f : 0.f,
                az = !(pick_x || pick_y) ? 1.f : 0.f;
    float p1x, p1y, p1z, p2x, p2y, p2z;
    cross(nx, ny, nz, ax, ay, az, p1x, p1y, p1z);
    normalize(p1x, p1y, p1z);
    cross(nx, ny, nz, p1x, p1y, p1z, p2x, p2y, p2z);
    normalize(p2x, p2y, p2z);
    const float c = mul(cosf(around), over);
    const float s = mul(sinf(around), over);
    ddx = add(add(mul(up, nx), mul(c, p1x)), mul(s, p2x));
    ddy = add(add(mul(up, ny), mul(c, p1y)), mul(s, p2y));
    ddz = add(add(mul(up, nz), mul(c, p1z)), mul(s, p2z));
  }
  // the mirror: reflect_planar
  const float k = mul(2.0f, dot(dx, dy, dz, nx, ny, nz));
  const float dsx = sub(dx, mul(k, nx)), dsy = sub(dy, mul(k, ny)),
              dsz = sub(dz, mul(k, nz));

  // Fresnel (Schlick) and the refracted direction
  const float safe_ior = tmax(ior, P_FLOOR);
  const float eta = outside ? dvd(1.f, safe_ior) : safe_ior;
  const float cos_i = clip(-dot(dx, dy, dz, nx, ny, nz), 0.f, 1.f);
  const float eta_i = outside ? 1.f : ior;
  const float eta_t = outside ? ior : 1.f;
  const float q = dvd(sub(eta_i, eta_t), add(eta_i, eta_t));
  const float r0 = mul(q, q);
  const float x = sub(1.f, cos_i);
  const float x2 = mul(x, x);
  const float fres = add(r0, mul(sub(1.f, r0), mul(x, mul(x2, x2))));
  const float sin2_t =
      mul(mul(eta, eta), tmax(sub(1.f, mul(cos_i, cos_i)), 0.f));
  const bool tir = sin2_t > 1.f;
  const float cos_t = sqrtf(tmax(sub(1.f, sin2_t), COS_FLOOR));
  const float k_r = sub(mul(eta, cos_i), cos_t);
  const bool refl_instead = tir || ldf(p, UF, i) < fres;
  float drx, dry, drz;
  if (refl_instead) {
    drx = dsx;
    dry = dsy;
    drz = dsz;
  } else {
    drx = add(mul(eta, dx), mul(k_r, nx));
    dry = add(mul(eta, dy), mul(k_r, ny));
    drz = add(mul(eta, dz), mul(k_r, nz));
  }
  float ndx = take_refr ? drx : take_spec ? dsx : ddx;
  float ndy = take_refr ? dry : take_spec ? dsy : ddy;
  float ndz = take_refr ? drz : take_spec ? dsz : ddz;
  normalize(ndx, ndy, ndz);

  const bool scattering = alive && hit_ok && !is_light;
  if (NEE) {
    // the direct term through the diffuse lobe, MIS-weighted
    const float wlx = ldf(p, WLX, i), wly = ldf(p, WLY, i),
                wlz = ldf(p, WLZ, i);
    const float cos_s = tmax(dot(nx, ny, nz, wlx, wly, wlz), 0.f);
    const bool nee_ok = scattering && !last && ldb(p, VIS, i);
    const float pdf_bd = mul(mul(p_diff, cos_s), INV_PI_F);
    const float wd =
        nee_ok ? dvd(pdf_bd, add(add(ldf(p, PDFL, i), pdf_bd), TINY_DIV))
               : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rad[c] = add(rad[c],
                   mul(mul(th[c], ldf(p, LEX + c, i)), mul(al[c], wd)));
  }

  // the throughput factor of the chosen lobe
  const float inv_pd = dvd(1.f, tmax(p_diff, P_FLOOR));
  const float inv_ps = dvd(1.f, tmax(p_spec, P_FLOOR));
  const float inv_pr = dvd(1.f, tmax(p_refr, P_FLOOR));
  // transmitted rays start just past the exact surface point; reflected
  // and diffuse rays keep the backed-off point
  const bool transmit = take_refr && !refl_instead;
  const float push = transmit ? PUSH : 0.f;
  const float nd[3] = {ndx, ndy, ndz};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float spec = mat[3 + c];
    const float factor = take_refr   ? mul(spec, inv_pr)
                         : take_spec ? mul(spec, inv_ps)
                                     : mul(al[c], inv_pd);
    p.out[OTX + c][i] = scattering ? mul(th[c], factor) : th[c];
    p.out[ORX + c][i] = rad[c];
    p.out[ODX + c][i] = nd[c];
    const float from = transmit ? ldf(p, SX + c, i) : ldf(p, PX + c, i);
    p.out[OX + c][i] = add(from, mul(push, nd[c]));
  }
  const bool still_alive = scattering && !last;
  p.out_alive[i] = still_alive ? 1 : 0;
  if (NEE) {
    // the chosen lobe's density at the new direction; 0 for the delta lobes
    const bool take_diff = still_alive && !take_refr && !take_spec;
    const float cos_next = tmax(dot(nx, ny, nz, ndx, ndy, ndz), 0.f);
    p.out[OPDF][i] = take_diff ? mul(mul(p_diff, cos_next), INV_PI_F) : 0.f;
  }
}

// The block's staged material rows (every thread reaches the barrier).
__device__ __forceinline__ void stage_rows(const Params& p, float* rows) {
  for (int m = threadIdx.x; m < p.m; m += blockDim.x)
    load_row(p, m, rows + ROW * m);
  __syncthreads();
}

// the launch tally (utils/launches.py), from one thread
__device__ __forceinline__ void tally(const Params& p) {
  if (p.launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    *p.launches += 1ull;
}

// STAGED: the rows staged in shared memory (m <= MAX_MATERIALS), else
// each lane's own row read from global memory into registers
template <bool NEE, bool TEX, bool STAGED>
__global__ void __launch_bounds__(THREADS) shade_kernel(const Params p) {
  extern __shared__ float rows[];
  tally(p);
  if (STAGED) stage_rows(p, rows);
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= p.n) return;
  if (STAGED) {
    shade_lane<NEE, TEX>(p, rows + ROW * material(p, i), i);
  } else {
    float row[ROW];
    load_row(p, material(p, i), row);
    shade_lane<NEE, TEX>(p, row, i);
  }
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS) shade_index_kernel(const Params p) {
  extern __shared__ float rows[];
  tally(p);
  if (STAGED) stage_rows(p, rows);
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= p.n) return;
  if (STAGED) {
    p.out_index[i] = fused_index(p, rows + ROW * material(p, i), i);
  } else {
    float row[ROW];
    load_row(p, material(p, i), row);
    p.out_index[i] = fused_index(p, row, i);
  }
}

// the checks and the fields both entry points share
int common(Params& p, long long n, const void* const* in,
           const long long* strides, const void* const* mats, int m,
           unsigned long long* launches) {
  if (n <= 0 || in == nullptr || strides == nullptr || mats == nullptr ||
      m <= 0)
    return cudaErrorInvalidValue;
  for (int k = 0; k < PLANES; ++k) {
    p.in[k] = in[k];
    p.stride[k] = strides[k];
  }
  for (int k = 0; k < TABLES; ++k) {
    if (mats[k] == nullptr) return cudaErrorInvalidValue;
    p.mats[k] = mats[k];
  }
  if (in[T_] == nullptr || in[U_] == nullptr || in[V_] == nullptr ||
      in[DX] == nullptr || in[DY] == nullptr || in[DZ] == nullptr ||
      in[MATID] == nullptr)
    return cudaErrorInvalidValue;
  p.m = m;
  p.n = n;
  p.launches = launches;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return cudaSuccess;
}

size_t smem_of(int m) { return sizeof(float) * ROW * m; }

// shade_kernel's instance for nee, tex and STAGED
template <bool STAGED>
void launch(int nee, int tex, const Params& p, long long n, void* stream) {
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  const size_t smem = STAGED ? smem_of(p.m) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nee && tex)
    shade_kernel<true, true, STAGED><<<blocks, THREADS, smem, s>>>(p);
  else if (nee)
    shade_kernel<true, false, STAGED><<<blocks, THREADS, smem, s>>>(p);
  else if (tex)
    shade_kernel<false, true, STAGED><<<blocks, THREADS, smem, s>>>(p);
  else
    shade_kernel<false, false, STAGED><<<blocks, THREADS, smem, s>>>(p);
}

}  // namespace

extern "C" int shade_launch(int nee, int tex, long long n,
                            const void* const* in, const long long* strides,
                            const void* const* mats, int m, const float* env,
                            const float* scale, float nee_area, int last,
                            float* const* out, unsigned char* out_alive,
                            unsigned long long* launches, void* stream) {
  Params p = {};
  int rc = common(p, n, in, strides, mats, m, launches);
  if (rc != cudaSuccess) return rc;
  for (int k = 0; k < PLANES; ++k) {
    const bool needed = (k < WLX || k == MATID || k == OUTSIDE ||
                         k == ALIVE) ||
                        (nee && k >= WLX && k <= PREV) || (nee && k == VIS) ||
                        (tex && k == TEXEL);
    if (needed && in[k] == nullptr) return cudaErrorInvalidValue;
  }
  if (scale == nullptr || (!tex && env == nullptr) || out == nullptr ||
      out_alive == nullptr)
    return cudaErrorInvalidValue;
  for (int k = 0; k < OUT_FLOATS; ++k) {
    if (out[k] == nullptr && (k != OPDF || nee)) return cudaErrorInvalidValue;
    p.out[k] = out[k];
  }
  p.env = env;
  p.scale = scale;
  p.nee_area = nee_area;
  p.last = last;
  p.out_alive = out_alive;
  if (m <= MAX_MATERIALS)
    launch<true>(nee, tex, p, n, stream);
  else
    launch<false>(nee, tex, p, n, stream);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shade_index_launch(long long n, const void* const* in,
                                  const long long* strides,
                                  const void* const* mats, int m, int ha,
                                  int wa, int he, int we, int* out,
                                  unsigned long long* launches,
                                  void* stream) {
  Params p = {};
  int rc = common(p, n, in, strides, mats, m, launches);
  if (rc != cudaSuccess) return rc;
  if (out == nullptr || ha <= 0 || wa <= 0 || he <= 0 || we <= 0)
    return cudaErrorInvalidValue;
  p.ha = ha;
  p.wa = wa;
  p.he = he;
  p.we = we;
  p.out_index = out;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= MAX_MATERIALS)
    shade_index_kernel<true><<<blocks, THREADS, smem_of(m), s>>>(p);
  else
    shade_index_kernel<false><<<blocks, THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shade_planes() { return PLANES; }

extern "C" const char* shade_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
