// Single-thread CPU reference baseline ("what the Rust CLI would do").
//
// The reference (pagmerek/frave) is a single-threaded Rust codec that
// publishes no numbers and is not built here, so the north-star
// denominator "single-thread CPU encode+decode MP/s" is measured from
// this faithful native reimplementation of the reference pipeline
// (encoder.rs:6-49 / decoder.rs:6-42 stage flow):
//
//   encode: geometry build per image (the reference rebuilds its tile
//   lattice per encode, wavelet_transform.rs:405-484) -> per-pixel
//   lifting (extract_coefficients, wavelet_transform.rs:179-225) ->
//   quantization -> least-squares predictor fit (context_modeling.rs:
//   204-213) -> per-symbol context modeling + histogramming
//   (prediction.rs:224-298) -> per-context table finalize
//   (entropy_coding.rs:102-159) -> serial per-symbol rANS push in
//   reverse order (entropy_coding.rs:266-352) -> byte serialization.
//
//   decode: geometry rebuild from (h, w) (from_metadata,
//   wavelet_transform.rs:392-403) -> table regen from (bits, off-list)
//   (serialize.rs:230-236) -> strictly sequential per-symbol decode that
//   recomputes each context from already-decoded neighbours
//   (entropy_coding.rs:205-264, the reference's decode bottleneck) ->
//   inverse lifting -> pixels.
//
// Honesty notes, biased AGAINST the JAX codec: this baseline uses
// flat precomputed index arrays (csrc/geometry.cpp) where the Rust
// reference chases per-pixel HashMaps, and -O3 -march=native scalar
// loops — i.e. it is FASTER than a literal port of the reference would
// be, so the measured vs_baseline ratio understates the true speedup.
// Context math (15 buckets, MED + learned 6-tap predictors, mask-aware
// lifting) matches frave_tpu's pipeline so both sides do the same work
// per pixel. The bitstream is self-consistent (round-trip verified every
// bench run) but deliberately NOT the frif container.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
int64_t fg_num_tiles(int height, int width, int depth);
int fg_build(int height, int width, int depth, int64_t T_expect,
             int32_t* centers, int32_t* pixel_gather, uint8_t* coef_mask,
             int32_t* nbr_idx, int32_t* nbr_par, int32_t* tile_nbr,
             int32_t* level_slots);
}

namespace refbase {

constexpr int kDepth = 9;
constexpr int kAlphabet = 1024;
constexpr int kContexts = 15;
constexpr int kMinBits = 8;
constexpr int kMaxBits = 14;
constexpr int32_t kPredClamp = 255;
constexpr uint32_t kRansL = 1u << 16;

static const float kBucketEdges[kContexts - 1] = {
    0.25f, 0.6f, 1.4f, 2.2f, 3.0f, 5.0f, 6.0f, 8.0f,
    12.0f, 16.0f, 20.0f, 25.0f, 30.0f, 42.0f};
static const double kBucketWidths[kContexts] = {
    0.1, 0.4, 1.0, 1.8, 2.5, 4.5, 6.3, 8.5, 12.7, 16.0, 20.0, 24.0, 28.0,
    36.0, 50.0};

struct Geometry {
  int h = 0, w = 0;
  int64_t T = 0;
  int n = 1 << kDepth;
  std::vector<int32_t> centers, pixel_gather, nbr_par, tile_nbr, level_slots;
  std::vector<uint8_t> coef_mask;

  bool build(int height, int width) {
    h = height;
    w = width;
    T = fg_num_tiles(h, w, kDepth);
    if (T <= 0) return false;
    centers.resize(T * 2);
    pixel_gather.resize(T * n);
    coef_mask.resize(T * n);
    nbr_par.resize(T * (int64_t)n * 6);
    tile_nbr.resize(T * 6);
    level_slots.resize(T * n);
    std::vector<int32_t> nbr_idx(T * (int64_t)n * 6);
    return fg_build(h, w, kDepth, T, centers.data(), pixel_gather.data(),
                    coef_mask.data(), nbr_idx.data(), nbr_par.data(),
                    tile_nbr.data(), level_slots.data()) == 0;
  }
};

static inline int32_t trunc_div2(int32_t a) { return a / 2; }  // C truncates

// Mask-aware forward lifting (frave_tpu/ops/lifting.py semantics).
static void forward_lifting(const Geometry& g, const int32_t* pix,
                            int32_t* coef /* [T*n] */) {
  const int n = g.n;
  std::vector<int32_t> vals(n), low(n / 2);
  std::vector<uint8_t> vm(n), lm(n / 2);
  for (int64_t t = 0; t < g.T; ++t) {
    const int32_t* P = &g.pixel_gather[t * n];
    int32_t* C = &coef[t * n];
    for (int j = 0; j < n; ++j) {
      vm[j] = P[j] >= 0;
      vals[j] = vm[j] ? pix[P[j]] : 0;
    }
    for (int level = kDepth - 1; level >= 0; --level) {
      int lo = 1 << level;
      for (int p = 0; p < lo; ++p) {
        int32_t L = vals[2 * p], R = vals[2 * p + 1];
        uint8_t Lm = vm[2 * p], Rm = vm[2 * p + 1];
        int32_t l0 = Lm ? L : 0, r0 = Rm ? R : 0;
        int32_t c = (Lm && Rm) ? l0 - r0 : 0;
        low[p] = (Lm && Rm) ? r0 + trunc_div2(c) : l0 + r0;
        lm[p] = Lm | Rm;
        C[lo + p] = c;
      }
      std::memcpy(vals.data(), low.data(), lo * sizeof(int32_t));
      std::memcpy(vm.data(), lm.data(), lo);
    }
    C[0] = vm[0] ? vals[0] : 0;
  }
}

static void inverse_lifting(const Geometry& g, const int32_t* coef,
                            int32_t* pix /* [h*w] */) {
  const int n = g.n;
  std::vector<int32_t> vals(n), nxt(n);
  std::vector<uint8_t> nodem(n);
  for (int64_t t = 0; t < g.T; ++t) {
    const int32_t* C = &coef[t * n];
    const uint8_t* M = &g.coef_mask[t * n];
    const int32_t* P = &g.pixel_gather[t * n];
    vals[0] = C[0];
    for (int level = 0; level < kDepth; ++level) {
      int lo = 1 << level;
      bool leaf = level == kDepth - 1;
      for (int p = 0; p < lo; ++p) {
        uint8_t Lm, Rm;
        if (leaf) {
          Lm = P[2 * p] >= 0;
          Rm = P[2 * p + 1] >= 0;
        } else {
          Lm = M[2 * (lo + p)];
          Rm = M[2 * (lo + p) + 1];
        }
        int32_t c = C[lo + p], v = vals[p];
        if (Lm && Rm) {
          int32_t R = v - trunc_div2(c);
          nxt[2 * p] = c + R;
          nxt[2 * p + 1] = R;
        } else {
          nxt[2 * p] = v;
          nxt[2 * p + 1] = v;
        }
      }
      std::memcpy(vals.data(), nxt.data(), 2 * lo * sizeof(int32_t));
    }
    for (int j = 0; j < n; ++j)
      if (P[j] >= 0) {
        int32_t v = vals[j];
        pix[P[j]] = v < 0 ? 0 : (v > 255 ? 255 : v);
      }
  }
}

// ---- schedule: DC phase, root phase, levels 1..depth-1 (parallel-mode
// contexts: all 6 taps at the parent level, frave_tpu geometry nbr_par).
struct Sym {
  int32_t slot;    // flat coefficient slot t*n + haar
  int32_t nbr[6];  // value slots, -1 absent
  uint8_t lf;      // MED context
  uint8_t group;   // predictor group 0/1/2
};

static void build_schedule(const Geometry& g, std::vector<Sym>& out) {
  const int n = g.n;
  out.clear();
  out.reserve(g.T * (int64_t)n);
  // level-0 phases: DC (haar 0) then root (haar 1); causal trio of tile
  // neighbours at the same haar slot (prediction.rs:86-149).
  for (int phase = 0; phase < 2; ++phase) {
    for (int64_t t = 0; t < g.T; ++t) {
      if (!g.coef_mask[t * n + phase]) continue;
      Sym s;
      s.slot = (int32_t)(t * n + phase);
      for (int k = 0; k < 3; ++k) {
        int32_t u = g.tile_nbr[t * 6 + k];
        // causality mask: the scan visits tiles in canonical order, so a
        // tap is usable only if the neighbour tile was already decoded
        // (the reference's serpentine scan guarantees this by
        // construction; here it is enforced explicitly)
        s.nbr[k] = (u >= 0 && u < t) ? (int32_t)(u * (int64_t)n + phase) : -1;
      }
      s.nbr[3] = s.nbr[4] = s.nbr[5] = -1;
      s.lf = 1;
      s.group = 0;
      out.push_back(s);
    }
  }
  int64_t off = g.T;  // level_slots layout: T entries for level 0 first
  for (int L = 1; L < kDepth; ++L) {
    int64_t cnt = g.T << L;
    uint8_t grp = L == kDepth - 1 ? 0 : (L == kDepth - 2 ? 1 : 2);
    for (int64_t i = 0; i < cnt; ++i) {
      int32_t slot = g.level_slots[off + i];
      if (!g.coef_mask[slot]) continue;
      Sym s;
      s.slot = slot;
      for (int k = 0; k < 6; ++k) s.nbr[k] = g.nbr_par[(int64_t)slot * 6 + k];
      s.lf = 0;
      s.group = grp;
      out.push_back(s);
    }
    off += cnt;
  }
}

static inline int assign_bucket(float w) {
  if (!(w > 0.0f)) w = 0.0f;  // NaN/negative -> 0
  int b = 0;
  for (int e = 0; e < kContexts - 1; ++e) b += w >= kBucketEdges[e];
  return b;
}

// Context computation — the self-consistency contract: encode and decode
// run this exact float op sequence (prediction.rs:205-264 analog).
static inline void context_of(const Sym& s, const int32_t* coef,
                              const float vp[3][6], const float wp[3][6],
                              int* bucket, int32_t* pred) {
  int32_t v[6];
  for (int k = 0; k < 6; ++k) v[k] = s.nbr[k] >= 0 ? coef[s.nbr[k]] : 0;
  if (s.lf) {
    int32_t v0 = v[0], v1 = v[1], v2 = v[2];
    int32_t mx = v0 > v2 ? v0 : v2, mn = v0 < v2 ? v0 : v2;
    int32_t med = v1 >= mx ? mx : (v1 <= mn ? mn : v0 + v2 - v1);
    *bucket = assign_bucket((float)std::abs(v0 - v2));
    *pred = med;
  } else {
    const float* a = vp[s.group];
    const float* b = wp[s.group];
    float f[6];
    for (int k = 0; k < 6; ++k) f[k] = (float)v[k];
    float g1 = std::fabs(f[0] - f[3]), g2 = std::fabs(f[1] - f[2]);
    float g3 = std::fabs(f[4] - f[5]), g4 = std::fabs(f[1] - f[5]);
    float g5 = std::fabs(f[2] - f[4]);
    float width = b[0] + b[1] * g1 + b[2] * g2 + b[3] * g3 + b[4] * g4 +
                  b[5] * g5;
    if (g1 + g2 + g3 + g4 + g5 == 0.0f) width = 0.0f;  // flat-context rule
    *bucket = assign_bucket(width);
    float p = f[0] * a[0] + f[1] * a[1] + f[2] * a[2] + f[3] * a[3] +
              f[4] * a[4] + f[5] * a[5];
    int32_t ip = std::isnan(p) ? 0 : (int32_t)p;  // trunc toward zero
    *pred = ip;
  }
  if (*pred > kPredClamp) *pred = kPredClamp;
  if (*pred < -kPredClamp) *pred = -kPredClamp;
}

// 6x6 linear solve (Gaussian elimination, partial pivot); singular
// directions fall to 0 via tiny ridge — same role as the reference's
// lstsq (context_modeling.rs:168,185).
static void solve6(double G[6][6], double b[6], float out[6]) {
  double A[6][7];
  double tr = 0;
  for (int i = 0; i < 6; ++i) tr += G[i][i];
  double eps = tr * 1e-9 / 6.0 + 1e-12;
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) A[i][j] = G[i][j] + (i == j ? eps : 0.0);
    A[i][6] = b[i];
  }
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    for (int r = c + 1; r < 6; ++r)
      if (std::fabs(A[r][c]) > std::fabs(A[piv][c])) piv = r;
    if (piv != c)
      for (int j = c; j < 7; ++j) std::swap(A[c][j], A[piv][j]);
    if (A[c][c] == 0.0) continue;
    for (int r = c + 1; r < 6; ++r) {
      double m = A[r][c] / A[c][c];
      for (int j = c; j < 7; ++j) A[r][j] -= m * A[c][j];
    }
  }
  for (int c = 5; c >= 0; --c) {
    double s = A[c][6];
    for (int j = c + 1; j < 6; ++j) s -= A[c][j] * (double)out[j];
    out[c] = A[c][c] != 0.0 ? (float)(s / A[c][c]) : 0.0f;
  }
}

struct Ctx {
  int bits;
  uint32_t freqs[kAlphabet];
  uint32_t cdf[kAlphabet];
  std::vector<uint16_t> off;
};

// Laplace fill + largest-remainder normalization (entropy_coding.rs:82-159
// pipeline; normalization algorithm as frave_tpu/entropy/tables.py).
static void finalize_context(const uint32_t* hist, int bucket, int bits_in,
                             const std::vector<uint16_t>& off_in, Ctx* out) {
  int bits = bits_in < kMinBits ? kMinBits : (bits_in > kMaxBits ? kMaxBits : bits_in);
  double width = kBucketWidths[bucket];
  double r = std::exp(-1.0 / width), s = 1.0 / (2.0 * width);
  bool offm[kAlphabet] = {false};
  for (uint16_t o : off_in)
    if (o < kAlphabet) offm[o] = true;
  int64_t filled[kAlphabet];
  bool off_out[kAlphabet];
  int nnz = 0;
  for (;;) {
    nnz = 0;
    double scale = (double)(1u << bits);
    // pmf per symbol: r^((j+1)/2) * s, r-power tracked incrementally
    double rp = 1.0;
    int prev_ax = 0;
    for (int j = 0; j < kAlphabet; ++j) {
      int ax = (j + 1) / 2;
      if (ax != prev_ax) {
        rp *= r;
        prev_ax = ax;
      }
      int64_t lap = (int64_t)(rp * s * scale);  // trunc
      bool data = hist != nullptr && hist[j] > 0;
      bool forced = lap == 0 && (data || offm[j]);
      filled[j] = forced ? 1 : lap;
      off_out[j] = offm[j] || (lap == 0 && data);
      nnz += filled[j] > 0;
    }
    if ((1 << bits) >= nnz || bits >= kMaxBits) break;
    ++bits;
  }
  // largest-remainder normalization with largest-donor fixup
  int64_t total = 0;
  for (int j = 0; j < kAlphabet; ++j) total += filled[j];
  int64_t target = 1 << bits;
  int64_t ssum = 0;
  static int64_t sv[kAlphabet];
  for (int j = 0; j < kAlphabet; ++j) {
    int64_t sc = filled[j] * target / total;
    sv[j] = filled[j] > 0 ? (sc > 1 ? sc : 1) : 0;
    ssum += sv[j];
  }
  int64_t diff = target - ssum;
  if (diff > 0) {
    int jmax = 0;
    for (int j = 1; j < kAlphabet; ++j)
      if (sv[j] > sv[jmax]) jmax = j;
    sv[jmax] += diff;
  } else {
    while (diff < 0) {
      int jmax = 0;
      for (int j = 1; j < kAlphabet; ++j)
        if (sv[j] > sv[jmax]) jmax = j;
      int64_t take = -diff < sv[jmax] - 1 ? -diff : sv[jmax] - 1;
      if (take <= 0) break;
      sv[jmax] -= take;
      diff += take;
    }
  }
  out->bits = bits;
  uint32_t c = 0;
  for (int j = 0; j < kAlphabet; ++j) {
    out->freqs[j] = (uint32_t)sv[j];
    out->cdf[j] = c;
    c += (uint32_t)sv[j];
  }
  out->off.clear();
  for (int j = 0; j < kAlphabet; ++j)
    if (off_out[j]) out->off.push_back((uint16_t)j);
}

// ---- serial rANS, one 32-bit stream per context (the reference keeps one
// interleaved stream per context bucket, entropy_coding.rs:266-352).
struct Enc {
  uint32_t x = kRansL;
  std::vector<uint16_t> words;  // emitted while encoding in reverse
};

static inline void rans_put(Enc& e, uint32_t f, uint32_t c, int bits) {
  uint32_t xmax = ((kRansL >> bits) << 16) * f;
  while (e.x >= xmax) {
    e.words.push_back((uint16_t)(e.x & 0xffff));
    e.x >>= 16;
  }
  e.x = ((e.x / f) << bits) + (e.x % f) + c;
}

struct Dec {
  uint32_t x;
  const uint16_t* words;
  size_t n, pos = 0;
};

static inline int rans_get(Dec& d, const Ctx& ctx) {
  uint32_t mask = (1u << ctx.bits) - 1;
  uint32_t slot = d.x & mask;
  // binary search: last s with cdf[s] <= slot (find_nearest_or_equal,
  // entropy_coding.rs:180-185)
  int lo = 0, hi = kAlphabet - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (ctx.cdf[mid] <= slot)
      lo = mid;
    else
      hi = mid - 1;
  }
  while (lo > 0 && ctx.freqs[lo] == 0) --lo;  // duplicate-cdf walk (:246-255)
  d.x = ctx.freqs[lo] * (d.x >> ctx.bits) + slot - ctx.cdf[lo];
  while (d.x < kRansL && d.pos < d.n) d.x = (d.x << 16) | d.words[d.pos++];
  return lo;
}

// ---- blob io
static void put_u32(std::vector<uint8_t>& b, uint32_t v) {
  b.push_back(v & 0xff);
  b.push_back((v >> 8) & 0xff);
  b.push_back((v >> 16) & 0xff);
  b.push_back((v >> 24) & 0xff);
}
static uint32_t get_u32(const uint8_t*& p) {
  uint32_t v = p[0] | (p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
  p += 4;
  return v;
}

struct ChannelWire {
  float vp[3][6], wp[3][6];
  int bits[kContexts];
  std::vector<uint16_t> off[kContexts];
  uint32_t states[kContexts];
  std::vector<uint16_t> words[kContexts];
};

}  // namespace refbase

namespace refbase {

// Geometry + schedule cache (one entry). The reference rebuilds its tile
// lattice per image (wavelet_transform.rs:405,392) — rb_use_cache(0)
// reproduces that; rb_use_cache(1) amortizes it like frave_tpu does,
// giving the CONSERVATIVE (faster) baseline the bench ratio is quoted
// against.
struct GeoCache {
  bool enabled = false;
  int h = -1, w = -1;
  Geometry g;
  std::vector<Sym> sched;

  bool get(int height, int width, Geometry** gp, std::vector<Sym>** sp,
           Geometry& local_g, std::vector<Sym>& local_s) {
    if (enabled && h == height && w == width) {
      *gp = &g;
      *sp = &sched;
      return true;
    }
    if (!local_g.build(height, width)) return false;
    build_schedule(local_g, local_s);
    if (enabled) {
      h = height;
      w = width;
      g = std::move(local_g);
      sched = std::move(local_s);
      *gp = &g;
      *sp = &sched;
    } else {
      *gp = &local_g;
      *sp = &local_s;
    }
    return true;
  }
};
static GeoCache g_cache;

}  // namespace refbase

using namespace refbase;

extern "C" {

void rb_use_cache(int on) {
  if (g_cache.enabled == (on != 0)) return;  // no-op: keep a warm cache
  g_cache.enabled = on != 0;
  g_cache.h = g_cache.w = -1;
}

// Encode: pixels [h*w*C] interleaved u8 -> malloc'd blob. Returns 0 ok.
int rb_encode(int h, int w, int C, const uint8_t* pixels, uint8_t** out_blob,
              int64_t* out_len) {
  Geometry lg;
  std::vector<Sym> lsched;
  Geometry* gp;
  std::vector<Sym>* sp;
  if (!g_cache.get(h, w, &gp, &sp, lg, lsched)) return 1;
  const Geometry& g = *gp;
  const std::vector<Sym>& sched = *sp;
  const int n = g.n;
  const int64_t K = (int64_t)sched.size();

  std::vector<uint8_t> blob;
  put_u32(blob, (uint32_t)h);
  put_u32(blob, (uint32_t)w);
  put_u32(blob, (uint32_t)C);

  std::vector<int32_t> plane(h * (int64_t)w), coef(g.T * (int64_t)n);
  for (int ch = 0; ch < C; ++ch) {
    for (int64_t i = 0; i < (int64_t)h * w; ++i)
      plane[i] = pixels[i * C + ch];
    forward_lifting(g, plane.data(), coef.data());
    // (all-ones quantization: lossless config, quantization.rs:3-5)

    // --- least-squares predictor fits over HF symbols
    double G[3][6][6] = {};
    double bv[3][6] = {};
    for (const Sym& s : sched) {
      if (s.lf) continue;
      double v[6];
      for (int k = 0; k < 6; ++k)
        v[k] = s.nbr[k] >= 0 ? (double)coef[s.nbr[k]] : 0.0;
      double y = (double)coef[s.slot];
      for (int a = 0; a < 6; ++a) {
        bv[s.group][a] += v[a] * y;
        for (int b2 = 0; b2 < 6; ++b2) G[s.group][a][b2] += v[a] * v[b2];
      }
    }
    float vp[3][6], wp[3][6];
    for (int grp = 0; grp < 3; ++grp) solve6(G[grp], bv[grp], vp[grp]);
    double Gw[3][6][6] = {};
    double bw[3][6] = {};
    for (const Sym& s : sched) {
      if (s.lf) continue;
      float f[6];
      for (int k = 0; k < 6; ++k)
        f[k] = s.nbr[k] >= 0 ? (float)coef[s.nbr[k]] : 0.0f;
      float p = 0;
      for (int k = 0; k < 6; ++k) p += f[k] * vp[s.group][k];
      double r = std::fabs((double)coef[s.slot] - (double)(int32_t)p);
      double feat[6] = {1.0, std::fabs((double)f[0] - f[3]),
                        std::fabs((double)f[1] - f[2]),
                        std::fabs((double)f[4] - f[5]),
                        std::fabs((double)f[1] - f[5]),
                        std::fabs((double)f[2] - f[4])};
      for (int a = 0; a < 6; ++a) {
        bw[s.group][a] += feat[a] * r;
        for (int b2 = 0; b2 < 6; ++b2) Gw[s.group][a][b2] += feat[a] * feat[b2];
      }
    }
    for (int grp = 0; grp < 3; ++grp) solve6(Gw[grp], bw[grp], wp[grp]);

    // --- contexts + symbols + histograms (per-symbol scalar loop)
    std::vector<int32_t> sym(K);
    std::vector<uint8_t> bkt(K);
    std::vector<uint32_t> hist(kContexts * kAlphabet, 0);
    for (int64_t i = 0; i < K; ++i) {
      int bucket;
      int32_t pred;
      context_of(sched[i], coef.data(), vp, wp, &bucket, &pred);
      int32_t r = coef[sched[i].slot] - pred;
      int32_t z = r >= 0 ? 2 * r : -2 * r - 1;  // pack_signed, utils.rs:34-40
      sym[i] = z;
      bkt[i] = (uint8_t)bucket;
      hist[bucket * kAlphabet + z] += 1;
    }

    // --- finalize per-context tables
    Ctx ctx[kContexts];
    for (int b = 0; b < kContexts; ++b) {
      int64_t total = 0;
      for (int j = 0; j < kAlphabet; ++j) total += hist[b * kAlphabet + j];
      int bits = kMinBits;
      if (total > 0) {
        bits = 0;
        while ((1ll << (bits + 1)) <= total) ++bits;  // floor(log2)
      }
      finalize_context(&hist[b * kAlphabet], b, bits, {}, &ctx[b]);
    }

    // --- serial rANS: push symbols in reverse scan order
    Enc enc[kContexts];
    for (int64_t i = K - 1; i >= 0; --i) {
      const Ctx& c = ctx[bkt[i]];
      rans_put(enc[bkt[i]], c.freqs[sym[i]], c.cdf[sym[i]], c.bits);
    }

    // --- serialize channel
    const uint8_t* vpb = (const uint8_t*)&vp[0][0];
    blob.insert(blob.end(), vpb, vpb + sizeof(vp));
    const uint8_t* wpb = (const uint8_t*)&wp[0][0];
    blob.insert(blob.end(), wpb, wpb + sizeof(wp));
    for (int b = 0; b < kContexts; ++b) {
      blob.push_back((uint8_t)ctx[b].bits);
      put_u32(blob, (uint32_t)ctx[b].off.size());
      const uint8_t* ob = (const uint8_t*)ctx[b].off.data();
      blob.insert(blob.end(), ob, ob + 2 * ctx[b].off.size());
      put_u32(blob, enc[b].x);
      put_u32(blob, (uint32_t)enc[b].words.size());
      // words were emitted in reverse-scan order; decoder pulls forward,
      // so store reversed
      for (int64_t i = (int64_t)enc[b].words.size() - 1; i >= 0; --i) {
        uint16_t wv = enc[b].words[i];
        blob.push_back(wv & 0xff);
        blob.push_back(wv >> 8);
      }
    }
  }

  *out_len = (int64_t)blob.size();
  *out_blob = (uint8_t*)std::malloc(blob.size());
  if (!*out_blob) return 2;
  std::memcpy(*out_blob, blob.data(), blob.size());
  return 0;
}

// Decode: blob -> pixels [h*w*C] u8 (caller-allocated). Returns 0 ok.
int rb_decode(const uint8_t* blob, int64_t len, uint8_t* out_pixels) {
  (void)len;
  const uint8_t* p = blob;
  int h = (int)get_u32(p), w = (int)get_u32(p), C = (int)get_u32(p);
  Geometry lg;
  std::vector<Sym> lsched;
  Geometry* gp;
  std::vector<Sym>* sp;
  if (!g_cache.get(h, w, &gp, &sp, lg, lsched)) return 1;  // from_metadata
  const Geometry& g = *gp;
  const std::vector<Sym>& sched = *sp;
  const int n = g.n;
  const int64_t K = (int64_t)sched.size();

  std::vector<int32_t> coef(g.T * (int64_t)n), plane(h * (int64_t)w, 0);
  for (int ch = 0; ch < C; ++ch) {
    float vp[3][6], wp[3][6];
    std::memcpy(vp, p, sizeof(vp));
    p += sizeof(vp);
    std::memcpy(wp, p, sizeof(wp));
    p += sizeof(wp);
    Ctx ctx[kContexts];
    Dec dec[kContexts];
    std::vector<uint16_t> words[kContexts];
    for (int b = 0; b < kContexts; ++b) {
      int bits = *p++;
      uint32_t off_len = get_u32(p);
      std::vector<uint16_t> off(off_len);
      std::memcpy(off.data(), p, 2 * off_len);
      p += 2 * off_len;
      finalize_context(nullptr, b, bits, off, &ctx[b]);  // wire regen
      uint32_t state = get_u32(p);
      uint32_t nw = get_u32(p);
      words[b].resize(nw);
      std::memcpy(words[b].data(), p, 2 * (size_t)nw);
      p += 2 * (size_t)nw;
      dec[b].x = state;
      dec[b].words = words[b].data();
      dec[b].n = nw;
    }

    std::fill(coef.begin(), coef.end(), 0);
    // strictly sequential decode: context recomputed per symbol from
    // already-decoded coefficients (the reference decode hot loop)
    for (int64_t i = 0; i < K; ++i) {
      int bucket;
      int32_t pred;
      context_of(sched[i], coef.data(), vp, wp, &bucket, &pred);
      int z = rans_get(dec[bucket], ctx[bucket]);
      int32_t r = (z % 2 == 0) ? z / 2 : -((z + 1) / 2);  // unpack_signed
      coef[sched[i].slot] = r + pred;
    }
    inverse_lifting(g, coef.data(), plane.data());
    for (int64_t i = 0; i < (int64_t)h * w; ++i)
      out_pixels[i * C + ch] = (uint8_t)plane[i];
  }
  return 0;
}

void rb_free(uint8_t* ptr) { std::free(ptr); }

}  // extern "C"
