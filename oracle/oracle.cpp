// TVC1 scalar oracle encoder/decoder (SURVEY.md §2.2, §4.3).
//
// An independent, trivially auditable C++ implementation of /root/repo/SPEC.md
// used as the bit-exactness referee for every JAX path (the reference
// binary the task metadata expects was never mounted — SURVEY.md §0), and as
// the single-core CPU baseline for bench.py's vs_baseline ratio.
//
// Deliberately plain scalar code: every formula is written exactly as SPEC.md
// states it, with none of the device-side vectorization tricks, so disagreement
// between this and the device paths localizes bugs immediately.
//
//   oracle encode <in.yuv> <out.tvc> <W> <H> <gop> <qp> <full|diamond|hier>
//                 <none|adaptive|bitrate|vbv|mb> <target_kbps> [max_frames]
//   oracle decode <in.tvc> <out.yuv>
//
// Exit 0 on success; stats on stderr, one JSON line on stdout.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <chrono>
#include <thread>
#include <atomic>
#include <cmath>

// ---------------------------------------------------------------- tables --
static const int32_t B[8][8] = {
    {362, 362, 362, 362, 362, 362, 362, 362},
    {502, 426, 284, 100, -100, -284, -426, -502},
    {473, 196, -196, -473, -473, -196, 196, 473},
    {426, -100, -502, -284, 284, 502, 100, -426},
    {362, -362, -362, 362, 362, -362, -362, 362},
    {284, -502, 100, 426, -426, -100, 502, -284},
    {196, -473, 473, -196, -196, 473, -473, 196},
    {100, -284, 426, -502, 502, -426, 284, -100},
};

static const int ZIGZAG[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

// SPEC.md §13.2 v3 quant matrix (raster 8x8): scale in 16ths, DC = unity
static int32_t QMAT8[64];
static void init_qmat() {
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) QMAT8[i * 8 + j] = 16 + 2 * (i + j);
  QMAT8[0] = 16;
}
static inline int32_t qpos_step(int32_t qs, int k, bool qmat) {
  if (!qmat) return qs;
  int32_t v = (int32_t)(((int64_t)qs * QMAT8[k] + 8) >> 4);
  return v < 1 ? 1 : v;
}

static int32_t QSTEP[64];
static void init_qstep() {
  init_qmat();
  for (int qp = 0; qp < 64; qp++) {
    double v = std::pow(2.0, qp / 6.0);
    int32_t s = (int32_t)std::floor(v + 0.5);
    QSTEP[qp] = s < 1 ? 1 : s;
  }
}

// ------------------------------------------------------------- primitives --
static inline int64_t rshift_round(int64_t v, int s) {
  int64_t mag = (std::llabs(v) + (1LL << (s - 1))) >> s;
  return v < 0 ? -mag : mag;
}

// SPEC.md §3: C = rr(rr(B·X,10)·Bᵀ,10)
static void fwd_tx(const int32_t x[64], int32_t c[64]) {
  int64_t t1[64], t1r[64], t2;
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) {
      int64_t acc = 0;
      for (int k = 0; k < 8; k++) acc += (int64_t)B[i][k] * x[k * 8 + j];
      t1[i * 8 + j] = acc;
    }
  for (int i = 0; i < 64; i++) t1r[i] = rshift_round(t1[i], 10);
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) {
      t2 = 0;
      for (int k = 0; k < 8; k++) t2 += t1r[i * 8 + k] * (int64_t)B[j][k];
      c[i * 8 + j] = (int32_t)rshift_round(t2, 10);
    }
}

// SPEC.md §3: R = rr(rr(Bᵀ·D,10)·B,10)
static void inv_tx(const int32_t d[64], int32_t r[64]) {
  int64_t u1[64], u1r[64], u2;
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) {
      int64_t acc = 0;
      for (int k = 0; k < 8; k++) acc += (int64_t)B[k][i] * d[k * 8 + j];
      u1[i * 8 + j] = acc;
    }
  for (int i = 0; i < 64; i++) u1r[i] = rshift_round(u1[i], 10);
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) {
      u2 = 0;
      for (int k = 0; k < 8; k++) u2 += u1r[i * 8 + k] * (int64_t)B[k][j];
      r[i * 8 + j] = (int32_t)rshift_round(u2, 10);
    }
}

static inline int32_t quant1(int32_t c, int32_t q, int bias16) {
  // bias16 = rounding offset in 16ths of a step; 8 = midpoint (the
  // historical (2|c|+q)/(2q)), smaller = deadzone. Encoder-side only:
  // dequantization and the bitstream format are unchanged.
  int64_t mag = (16LL * std::llabs(c) + (int64_t)bias16 * q) / (16LL * q);
  return c < 0 ? (int32_t)-mag : (int32_t)mag;
}

static inline int bitlen_u(uint64_t x) {
  int n = 0;
  while (x) { n++; x >>= 1; }
  return n;
}

// ---------------------------------------------------------------- bit I/O --
struct BitWriter {
  std::vector<uint32_t> words;  // big-endian bit order within each word
  uint64_t nbits = 0;
  void put(uint32_t value, int len) {
    if (!len) return;
    uint64_t pos = nbits;
    size_t w = pos >> 5;
    int s = pos & 31;
    while (words.size() < w + 2) words.push_back(0);
    int avail = 32 - s;
    if (len <= avail) {
      words[w] |= value << (avail - len);
    } else {
      int hi = len - avail;
      words[w] |= value >> hi;
      words[w + 1] |= (value & ((1u << hi) - 1)) << (32 - hi);
    }
    nbits += len;
  }
  void put_ue(uint32_t v) {
    uint32_t code = v + 1;
    int k = bitlen_u(code) - 1;
    put(code, 2 * k + 1);
  }
  void put_se(int32_t v) { put_ue(v > 0 ? 2 * v - 1 : -2 * v); }
};

struct BitReader {
  const uint8_t* data;
  uint64_t nbits, pos = 0;
  BitReader(const uint8_t* d, uint64_t n) : data(d), nbits(n) {}
  uint32_t get(int len) {
    // Bounds-safe: bits past nbits read as 1 (so get_ue's zero-scan always
    // terminates on truncated/corrupt payloads) and pos runs past nbits,
    // which every parse loop checks and reports as a corrupt stream.
    uint32_t v = 0;
    for (int i = 0; i < len; i++) {
      uint64_t p = pos + i;
      uint32_t bit = p < nbits ? ((data[p >> 3] >> (7 - (p & 7))) & 1) : 1u;
      v = (v << 1) | bit;
    }
    pos += len;
    return v;
  }
  uint32_t get_ue() {
    int zeros = 0;
    while (get(1) == 0) {
      if (++zeros > 31) { pos = nbits + 1; return 0; }  // corrupt: poison pos
    }
    return ((1u << zeros) | get(zeros)) - 1;
  }
  int32_t get_se() {
    uint32_t m = get_ue();
    return (m & 1) ? (int32_t)((m + 1) >> 1) : -(int32_t)(m >> 1);
  }
};

// --------------------------------------------------------------- planes ----
struct Plane {
  int w = 0, h = 0;
  std::vector<int32_t> px;
  int32_t at(int y, int x) const { return px[(size_t)y * w + x]; }
  int32_t& at(int y, int x) { return px[(size_t)y * w + x]; }
  // edge-clamped read (SPEC.md §2 padded reference semantics)
  int32_t clamped(int y, int x) const {
    if (y < 0) y = 0; if (y >= h) y = h - 1;
    if (x < 0) x = 0; if (x >= w) x = w - 1;
    return px[(size_t)y * w + x];
  }
};

static Plane pad_to(const uint8_t* src, int w, int h, int mult) {
  int wp = (w + mult - 1) / mult * mult, hp = (h + mult - 1) / mult * mult;
  Plane p; p.w = wp; p.h = hp; p.px.resize((size_t)wp * hp);
  for (int y = 0; y < hp; y++)
    for (int x = 0; x < wp; x++) {
      int sy = y < h ? y : h - 1, sx = x < w ? x : w - 1;
      p.at(y, x) = src[(size_t)sy * w + sx];
    }
  return p;
}

// ------------------------------------------------------------- containers --
static void put_le16(std::vector<uint8_t>& b, uint16_t v) { b.push_back(v & 255); b.push_back(v >> 8); }
static void put_le32(std::vector<uint8_t>& b, uint32_t v) { for (int i = 0; i < 4; i++) b.push_back((v >> (8 * i)) & 255); }
static uint16_t get_le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
static uint32_t get_le32(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24); }

// --------------------------------------------------------------- encoder ---
struct Config {
  int w, h, gop, qp;
  int search;  // 0 full, 1 diamond, 2 hier (SPEC.md §9)
  int rc;  // 0 none, 1 adaptive, 2 bitrate, 3 vbv
  int target_bits;
  int vbv_bits = 0;  // rc=3 buffer size (0 -> 8x per-frame target)
  int fmt = 1;   // bitstream format (SPEC.md §8 v1 / §12 v2 / §13 v3)
  int cqpo = 0;  // v2 chroma QP offset
  int qbias = 8; // AC quantizer rounding bias /16 (8 = midpoint)
  int qmat = 0;  // v3 quant matrix flag (SPEC.md §13.2)
  int islice = 0;  // v3 intra-slice height in MB rows (SPEC.md §13.3)
};

static Plane down2(const Plane& p) {
  // 2x2 box downsample, round half up (SPEC.md §9 hier; = spec.down2)
  Plane q; q.w = p.w / 2; q.h = p.h / 2;
  q.px.resize((size_t)q.w * q.h);
  for (int i = 0; i < q.h; i++)
    for (int j = 0; j < q.w; j++)
      q.at(i, j) = (p.at(2 * i, 2 * j) + p.at(2 * i, 2 * j + 1) +
                    p.at(2 * i + 1, 2 * j) + p.at(2 * i + 1, 2 * j + 1) + 2) >> 2;
  return q;
}

static int64_t sad4q(const Plane& cq, const Plane& rq, int my, int mx,
                     int dy, int dx) {
  // SAD of MB (my, mx)'s 4x4 quarter-res block at offset (dy, dx);
  // clamped() == the edge-padded quarter reference
  int64_t s = 0;
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++)
      s += std::llabs(cq.at(my * 4 + i, mx * 4 + j) -
                      rq.clamped(my * 4 + dy + i, mx * 4 + dx + j));
  return s;
}

static int64_t sad16(const Plane& cur, const Plane& ref, int my, int mx, int dy, int dx) {
  int64_t s = 0;
  for (int i = 0; i < 16; i++)
    for (int j = 0; j < 16; j++)
      s += std::llabs(cur.at(my * 16 + i, mx * 16 + j) -
                      ref.clamped(my * 16 + dy + i, mx * 16 + dx + j));
  return s;
}

// SPEC.md §14.2 (format v4): sample of the (fy, fx) parity plane —
// computed on the plane grid with clamped +1 reads — edge-replication
// padded. Half-pel MC reads exactly this.
static inline int32_t hpel_clamped(const Plane& p, int y, int x, int fy, int fx) {
  if (y < 0) y = 0; if (y >= p.h) y = p.h - 1;
  if (x < 0) x = 0; if (x >= p.w) x = p.w - 1;
  int y1 = y + 1 < p.h ? y + 1 : p.h - 1;
  int x1 = x + 1 < p.w ? x + 1 : p.w - 1;
  if (!fy && !fx) return p.at(y, x);
  if (!fy) return (p.at(y, x) + p.at(y, x1) + 1) >> 1;
  if (!fx) return (p.at(y, x) + p.at(y1, x) + 1) >> 1;
  return (p.at(y, x) + p.at(y, x1) + p.at(y1, x) + p.at(y1, x1) + 2) >> 2;
}

static int64_t sad16_hpel(const Plane& cur, const Plane& ref, int my, int mx,
                          int d2y, int d2x) {
  int iy = d2y >> 1, ix = d2x >> 1, fy = d2y & 1, fx = d2x & 1;
  int64_t s = 0;
  for (int i = 0; i < 16; i++)
    for (int j = 0; j < 16; j++)
      s += std::llabs(cur.at(my * 16 + i, mx * 16 + j) -
                      hpel_clamped(ref, my * 16 + iy + i, mx * 16 + ix + j,
                                   fy, fx));
  return s;
}

struct MB {
  bool inter = false;
  int dy = 0, dx = 0, qp = 0;
  int32_t zz[6][64];
};

struct FrameOut {
  std::vector<uint8_t> payload;  // big-endian serialized, word padded
  uint64_t bits = 0;
};

static void encode_frame(const Config& cfg, bool is_p,
                         const Plane& cy, const Plane& ccb, const Plane& ccr,
                         Plane& ry, Plane& rcb, Plane& rcr,  // in: ref, out: recon
                         int base_qp, FrameOut& out,
                         const std::vector<int32_t>* qp_ofs = nullptr,
                         std::vector<int32_t>* mb_bits_out = nullptr) {
  int nby = cy.h / 16, nbx = cy.w / 16;
  if (mb_bits_out) mb_bits_out->assign((size_t)nby * nbx, 0);
  std::vector<MB> mbs((size_t)nby * nbx);
  Plane ref_y = ry, ref_cb = rcb, ref_cr = rcr;
  // hier search: 4x-downsampled planes, once per frame (SPEC.md §9)
  Plane cq, rq;
  if (cfg.search == 2 && is_p) {
    cq = down2(down2(cy));
    rq = down2(down2(ref_y));
  }
  // v2 DC DPCM grids (SPEC.md §12.4): quantized DC level per plane block
  std::vector<int32_t> dcy((size_t)4 * nby * nbx, 0);
  std::vector<int32_t> dcc0((size_t)nby * nbx, 0), dcc1((size_t)nby * nbx, 0);

  BitWriter bw;
  for (int my = 0; my < nby; my++)
    for (int mx = 0; mx < nbx; mx++) {
      uint64_t mb_start_bits = bw.nbits;
      MB& mb = mbs[(size_t)my * nbx + mx];
      // mode decision + ME (SPEC.md §9)
      int64_t sum = 0;
      for (int i = 0; i < 16; i++)
        for (int j = 0; j < 16; j++) sum += cy.at(my * 16 + i, mx * 16 + j);
      int64_t dc = (sum + 128) >> 8;
      int64_t icost = 0;
      for (int i = 0; i < 16; i++)
        for (int j = 0; j < 16; j++)
          icost += std::llabs(cy.at(my * 16 + i, mx * 16 + j) - dc);

      if (is_p) {
        int64_t best = INT64_MAX;
        int bdy = 0, bdx = 0;
        if (cfg.search == 0) {
          for (int dy = -16; dy <= 16; dy++)
            for (int dx = -16; dx <= 16; dx++) {
              int64_t s = sad16(cy, ref_y, my, mx, dy, dx);
              if (s < best) { best = s; bdy = dy; bdx = dx; }
            }
        } else if (cfg.search == 2) {
          // SPEC.md §9 hier: coarse ±4 on quarter res, x4, refine ±2
          int64_t cb = INT64_MAX;
          int cdy = 0, cdx = 0;
          for (int dy = -4; dy <= 4; dy++)
            for (int dx = -4; dx <= 4; dx++) {
              int64_t s = sad4q(cq, rq, my, mx, dy, dx);
              if (s < cb) { cb = s; cdy = dy; cdx = dx; }
            }
          cdy *= 4; cdx *= 4;
          bdy = cdy; bdx = cdx;
          // two chained ±2 refines, each re-centered (SPEC.md §9)
          for (int step = 0; step < 2; step++) {
            int sy = bdy, sx = bdx;
            best = INT64_MAX;
            for (int u = -2; u <= 2; u++)
              for (int v = -2; v <= 2; v++) {
                int ny = sy + u, nx = sx + v;
                int64_t s = (std::abs(ny) <= 16 && std::abs(nx) <= 16)
                                ? sad16(cy, ref_y, my, mx, ny, nx)
                                : (1LL << 60);
                if (s < best) { best = s; bdy = ny; bdx = nx; }
              }
          }
        } else {
          // SPEC.md §9 diamond with early freeze; SDSP applied regardless
          int dy = 0, dx = 0;
          int64_t cost = sad16(cy, ref_y, my, mx, 0, 0);
          bool frozen = cost < 512;
          static const int LD[4][2] = {{-2, 0}, {0, -2}, {0, 2}, {2, 0}};
          for (int step = 0; step < 16 && !frozen; step++) {
            int wdy = dy, wdx = dx;
            int64_t wc = cost;
            int widx = 0, ci = 1;
            for (auto& o : LD) {
              int ny = dy + o[0], nx = dx + o[1];
              int64_t c = (std::abs(ny) <= 16 && std::abs(nx) <= 16)
                              ? sad16(cy, ref_y, my, mx, ny, nx)
                              : (1LL << 60);
              if (c < wc) { wc = c; wdy = ny; wdx = nx; widx = ci; }
              ci++;
            }
            bool moved = widx != 0;
            dy = wdy; dx = wdx; cost = wc;
            frozen = !moved || cost < 512;
          }
          static const int SD[4][2] = {{-1, 0}, {0, -1}, {0, 1}, {1, 0}};
          {
            int wdy = dy, wdx = dx;
            int64_t wc = cost;
            for (auto& o : SD) {
              int ny = dy + o[0], nx = dx + o[1];
              int64_t c = (std::abs(ny) <= 16 && std::abs(nx) <= 16)
                              ? sad16(cy, ref_y, my, mx, ny, nx)
                              : (1LL << 60);
              if (c < wc) { wc = c; wdy = ny; wdx = nx; }
            }
            dy = wdy; dx = wdx; cost = wc;
          }
          best = cost; bdy = dy; bdx = dx;
        }
        if (cfg.fmt >= 4) {
          // SPEC.md §14.4: half-pel refinement, row-major first-minimum
          int64_t hb = INT64_MAX; int hdy = 0, hdx = 0;
          for (int u = -1; u <= 1; u++)
            for (int v = -1; v <= 1; v++) {
              int ny = 2 * bdy + u, nx = 2 * bdx + v;
              int64_t s = (std::abs(ny) <= 32 && std::abs(nx) <= 32)
                              ? sad16_hpel(cy, ref_y, my, mx, ny, nx)
                              : (1LL << 60);
              if (s < hb) { hb = s; hdy = ny; hdx = nx; }
            }
          best = hb; bdy = hdy; bdx = hdx;  // half-pel units from here on
        }
        mb.inter = best <= icost;
        mb.dy = bdy; mb.dx = bdx;
      }

      // rate control (SPEC.md §10)
      if (qp_ofs) {
        // rc=mb pass 2 (SPEC.md §10.4): per-MB offsets from pass-1 bits
        int q = base_qp + (*qp_ofs)[(size_t)my * nbx + mx];
        mb.qp = q < 1 ? 1 : (q > 63 ? 63 : q);
      } else if (cfg.rc == 1) {
        int bl = icost > 0 ? bitlen_u((uint64_t)icost) : 0;
        int q = base_qp + (bl - 10);
        mb.qp = q < 1 ? 1 : (q > 63 ? 63 : q);
      } else {
        mb.qp = base_qp;
      }
      int32_t qs = QSTEP[mb.qp];
      int qpc = mb.qp + (cfg.fmt >= 2 ? cfg.cqpo : 0);
      if (qpc < 1) qpc = 1; if (qpc > 63) qpc = 63;
      int32_t qsc = QSTEP[qpc];  // v2 chroma step (== qs for v1)

      // 6 blocks: residual -> transform -> quant -> zigzag; recon in place
      for (int b = 0; b < 6; b++) {
        static const int OFF[4][2] = {{0, 0}, {0, 8}, {8, 0}, {8, 8}};
        const Plane* cp; Plane* rp; const Plane* refp;
        int oy, ox, cdy, cdx;
        if (b < 4) {
          cp = &cy; rp = &ry; refp = &ref_y;
          oy = my * 16 + OFF[b][0]; ox = mx * 16 + OFF[b][1];
          cdy = mb.dy; cdx = mb.dx;
        } else {
          cp = (b == 4) ? &ccb : &ccr;
          rp = (b == 4) ? &rcb : &rcr;
          refp = (b == 4) ? &ref_cb : &ref_cr;
          oy = my * 8; ox = mx * 8;
          cdy = mb.dy >> 1; cdx = mb.dx >> 1;
        }
        int32_t pred[64], resid[64], coef[64], deq[64], rec[64];
        for (int i = 0; i < 8; i++)
          for (int j = 0; j < 8; j++) {
            int32_t p;
            if (mb.inter)
              p = cfg.fmt >= 4
                      ? hpel_clamped(*refp, oy + (cdy >> 1) + i,
                                     ox + (cdx >> 1) + j, cdy & 1, cdx & 1)
                      : refp->clamped(oy + cdy + i, ox + cdx + j);
            else if (cfg.fmt >= 3 && !is_p) {
              // v3 I-frame vertical intra (SPEC.md §13.1): the recon pixel
              // row directly above this block (raster order guarantees it
              // is final; 128 above the frame's first row). §13.3 intra
              // slices: the predictor also resets at every slice top
              // (islice MB rows = islice*16 luma / islice*8 chroma px).
              int spx = cfg.islice * (b < 4 ? 16 : 8);
              bool top = oy == 0 || (spx && oy % spx == 0);
              p = top ? 128 : rp->at(oy - 1, ox + j);
            }
            else
              p = 128;
            pred[i * 8 + j] = p;
            resid[i * 8 + j] = cp->at(oy + i, ox + j) - p;
          }
        fwd_tx(resid, coef);
        int32_t qb = b < 4 ? qs : qsc;
        int32_t lv[64];
        for (int i = 0; i < 64; i++)
          lv[i] = quant1(coef[i], qpos_step(qb, i, cfg.qmat),
                         i == 0 ? 8 : cfg.qbias);
        for (int k = 0; k < 64; k++) mb.zz[b][k] = lv[ZIGZAG[k]];
        for (int i = 0; i < 64; i++)
          deq[i] = lv[i] * qpos_step(qb, i, cfg.qmat);
        inv_tx(deq, rec);
        for (int i = 0; i < 8; i++)
          for (int j = 0; j < 8; j++) {
            int32_t v = pred[i * 8 + j] + rec[i * 8 + j];
            rp->at(oy + i, ox + j) = v < 0 ? 0 : (v > 255 ? 255 : v);
          }
      }

      // entropy (SPEC.md §7 v1 / §12.5 v2)
      if (is_p) {
        bw.put_ue(mb.inter ? 0 : 1);
        if (mb.inter) {
          int pdx = 0, pdy = 0;
          if (cfg.fmt >= 2 && mx > 0) {
            const MB& lmb = mbs[(size_t)my * nbx + mx - 1];
            if (lmb.inter) { pdx = lmb.dx; pdy = lmb.dy; }
          }
          bw.put_se(mb.dx - pdx);
          bw.put_se(mb.dy - pdy);
        }
      }
      bw.put_se(mb.qp - base_qp);
      for (int b = 0; b < 6; b++) {
        if (cfg.fmt >= 2) {
          // v2: cbf, se(dcd), ue(nnz_ac), AC runs from zigzag position 1
          int32_t dc = mb.zz[b][0];
          int nnz_ac = 0;
          for (int k = 1; k < 64; k++) nnz_ac += mb.zz[b][k] != 0;
          // update the DC grids with this block's final DC level
          int32_t pdc = 0;
          if (b < 4) {
            int by = 2 * my + (b >> 1), bx = 2 * mx + (b & 1);
            if (bx > 0) pdc = dcy[(size_t)by * 2 * nbx + bx - 1];
            dcy[(size_t)by * 2 * nbx + bx] = dc;
          } else {
            std::vector<int32_t>& g = (b == 4) ? dcc0 : dcc1;
            if (mx > 0) pdc = g[(size_t)my * nbx + mx - 1];
            g[(size_t)my * nbx + mx] = dc;
          }
          if (dc == 0 && nnz_ac == 0) { bw.put(0, 1); continue; }
          bw.put(1, 1);
          bw.put_se(dc - pdc);
          bw.put_ue(nnz_ac);
          int prev = 0;
          for (int k = 1; k < 64; k++)
            if (mb.zz[b][k]) {
              bw.put_ue(k - prev - 1);
              bw.put_se(mb.zz[b][k]);
              prev = k;
            }
          continue;
        }
        int nnz = 0;
        for (int k = 0; k < 64; k++) nnz += mb.zz[b][k] != 0;
        if (!nnz) { bw.put(0, 1); continue; }
        bw.put(1, 1);
        bw.put_ue(nnz - 1);
        int prev = -1;
        for (int k = 0; k < 64; k++)
          if (mb.zz[b][k]) {
            bw.put_ue(k - prev - 1);
            bw.put_se(mb.zz[b][k]);
            prev = k;
          }
      }
      if (mb_bits_out)
        (*mb_bits_out)[(size_t)my * nbx + mx] =
            (int32_t)(bw.nbits - mb_start_bits);
    }

  out.bits = bw.nbits;
  size_t nw = (bw.nbits + 31) / 32;
  out.payload.resize(nw * 4);
  for (size_t i = 0; i < nw; i++) {
    uint32_t w = i < bw.words.size() ? bw.words[i] : 0;
    out.payload[4 * i] = w >> 24;
    out.payload[4 * i + 1] = (w >> 16) & 255;
    out.payload[4 * i + 2] = (w >> 8) & 255;
    out.payload[4 * i + 3] = w & 255;
  }
}

// --------------------------------------------------------------- decoder ---
static void decode_frame(int w, int h, bool is_p, int base_qp,
                         const uint8_t* payload, uint64_t nbits,
                         Plane& ry, Plane& rcb, Plane& rcr,
                         int version = 1, int cqpo = 0, bool qmat = false,
                         int islice = 0) {
  int wp = (w + 15) / 16 * 16, hp = (h + 15) / 16 * 16;
  int nby = hp / 16, nbx = wp / 16;
  Plane ref_y = ry, ref_cb = rcb, ref_cr = rcr;
  // v2 prediction state (SPEC.md §12.3-12.4)
  std::vector<int32_t> dcy((size_t)4 * nby * nbx, 0);
  std::vector<int32_t> dcc0((size_t)nby * nbx, 0), dcc1((size_t)nby * nbx, 0);
  std::vector<int32_t> mvrow_dx(nbx, 0), mvrow_dy(nbx, 0);
  std::vector<uint8_t> mvrow_inter(nbx, 0);
  BitReader br(payload, nbits);
  for (int my = 0; my < nby; my++)
    for (int mx = 0; mx < nbx; mx++) {
      bool inter = false;
      int dy = 0, dx = 0;
      if (is_p) {
        uint32_t mode = br.get_ue();
        if (mode == 0) {
          inter = true; dx = br.get_se(); dy = br.get_se();
          if (version >= 2 && mx > 0 && mvrow_inter[mx - 1]) {
            dx += mvrow_dx[mx - 1];
            dy += mvrow_dy[mx - 1];
          }
        }
        mvrow_inter[mx] = inter;
        mvrow_dx[mx] = dx;
        mvrow_dy[mx] = dy;
      }
      int qp = base_qp + br.get_se();
      if (qp < 1 || qp > 63) qp = qp < 1 ? 1 : 63;  // corrupt-stream clamp
      int qpc = qp + (version >= 2 ? cqpo : 0);
      if (qpc < 1) qpc = 1; if (qpc > 63) qpc = 63;
      for (int b = 0; b < 6; b++) {
        int32_t qs = QSTEP[b < 4 ? qp : qpc];
        int32_t zz[64] = {0};
        if (version >= 2) {
          int32_t pdc = 0;
          int by = 0, bx = 0;
          if (b < 4) {
            by = 2 * my + (b >> 1); bx = 2 * mx + (b & 1);
            if (bx > 0) pdc = dcy[(size_t)by * 2 * nbx + bx - 1];
          } else if (mx > 0) {
            pdc = (b == 4 ? dcc0 : dcc1)[(size_t)my * nbx + mx - 1];
          }
          if (br.get(1)) {
            zz[0] = pdc + br.get_se();
            int nnz_ac = br.get_ue(), pos = 0;
            if (nnz_ac > 63) nnz_ac = 63;  // corrupt-stream clamp
            for (int t = 0; t < nnz_ac; t++) {
              pos += br.get_ue() + 1;
              if (pos >= 64 || br.pos > br.nbits) break;  // corrupt stream
              zz[pos] = br.get_se();
            }
          }
          if (b < 4) dcy[(size_t)by * 2 * nbx + bx] = zz[0];
          else (b == 4 ? dcc0 : dcc1)[(size_t)my * nbx + mx] = zz[0];
        } else if (br.get(1)) {
          int nnz = br.get_ue() + 1, pos = -1;
          if (nnz > 64) nnz = 64;  // corrupt-stream clamp
          for (int t = 0; t < nnz; t++) {
            pos += br.get_ue() + 1;
            if (pos >= 64 || br.pos > br.nbits) break;  // corrupt stream
            zz[pos] = br.get_se();
          }
        }
        static const int OFF[4][2] = {{0, 0}, {0, 8}, {8, 0}, {8, 8}};
        Plane* rp; const Plane* refp;
        int oy, ox, cdy, cdx;
        if (b < 4) {
          rp = &ry; refp = &ref_y;
          oy = my * 16 + OFF[b][0]; ox = mx * 16 + OFF[b][1];
          cdy = dy; cdx = dx;
        } else {
          rp = (b == 4) ? &rcb : &rcr;
          refp = (b == 4) ? &ref_cb : &ref_cr;
          oy = my * 8; ox = mx * 8;
          cdy = dy >> 1; cdx = dx >> 1;
        }
        int32_t lv[64], deq[64], rec[64];
        for (int i = 0; i < 64; i++) lv[i] = 0;
        for (int k = 0; k < 64; k++) lv[ZIGZAG[k]] = zz[k];
        for (int i = 0; i < 64; i++)
          deq[i] = lv[i] * qpos_step(qs, i, qmat);
        inv_tx(deq, rec);
        for (int i = 0; i < 8; i++)
          for (int j = 0; j < 8; j++) {
            int32_t p;
            if (inter)
              p = version >= 4
                      ? hpel_clamped(*refp, oy + (cdy >> 1) + i,
                                     ox + (cdx >> 1) + j, cdy & 1, cdx & 1)
                      : refp->clamped(oy + cdy + i, ox + cdx + j);
            else if (version >= 3 && !is_p) {
              // v3 I-frame vertical intra (SPEC.md §13.1) with the §13.3
              // intra-slice reset
              int spx = islice * (b < 4 ? 16 : 8);
              bool top = oy == 0 || (spx && oy % spx == 0);
              p = top ? 128 : rp->at(oy - 1, ox + j);
            }
            else
              p = 128;
            int32_t v = p + rec[i * 8 + j];
            rp->at(oy + i, ox + j) = v < 0 ? 0 : (v > 255 ? 255 : v);
          }
      }
    }
}

// ----------------------------------------------------------- C library API --
// Used by video_encoder/codec/native.py (ctypes) as the fast host
// entropy decoder: the serial bit-parsing stage of decode is byte-stream
// bound and lives on the host (SURVEY.md §7.0 "Host does bytes, device does
// math"); reconstruction can then run on-device from the parsed arrays.

extern "C" {

// Parse one frame's payload into PER-PLANE int16 level arrays, matching the
// device GOP decoder's layout (pipeline/decoder.py decode_gop_jit):
//   ly:  [2*nby, 2*nbx, 64]  luma 8x8 blocks, raster order
//   lcb: [nby, nbx, 64], lcr: [nby, nbx, 64]
//   mvs: [nby*nbx*2] (dy, dx), inter/qps: [nby*nbx]
// Caller provides zeroed buffers. int16 halves the host->device upload
// (levels are <= 2047). Returns 0 on success.
int tvc_parse_frame_planes(const uint8_t* payload, uint64_t nbits, int is_p,
                           int base_qp, int nby, int nbx, int16_t* ly,
                           int16_t* lcb, int16_t* lcr, int32_t* mvs,
                           uint8_t* inter, int32_t* qps, int version) {
  BitReader br(payload, nbits);
  int prev_dx = 0, prev_dy = 0, prev_inter = 0;  // v2 left-MB mv state
  for (int m = 0; m < nby * nbx; m++) {
    int my = m / nbx, mx = m % nbx;
    bool mb_inter = false;
    int dy = 0, dx = 0;
    if (is_p) {
      if (br.get_ue() == 0) {
        mb_inter = true; dx = br.get_se(); dy = br.get_se();
        if (version >= 2 && mx > 0 && prev_inter) { dx += prev_dx; dy += prev_dy; }
      }
      prev_inter = mb_inter; prev_dx = dx; prev_dy = dy;
    }
    int qp = base_qp + br.get_se();
    qps[m] = qp < 1 ? 1 : (qp > 63 ? 63 : qp);  // corrupt-stream clamp
    int mvr = version >= 4 ? 32 : 16;  // v4: half-pel units (SPEC.md §14.1)
    if (dy < -mvr || dy > mvr || dx < -mvr || dx > mvr) return 3;
    inter[m] = mb_inter;
    mvs[2 * m] = dy;
    mvs[2 * m + 1] = dx;
    for (int b = 0; b < 6; b++) {
      int16_t* dst;
      if (b < 4) {
        int by = 2 * my + (b >> 1), bx = 2 * mx + (b & 1);
        dst = ly + ((size_t)by * (2 * nbx) + bx) * 64;
      } else {
        dst = (b == 4 ? lcb : lcr) + (size_t)m * 64;
      }
      if (version >= 2) {
        // DC pred = left block's level in the output arrays themselves
        int32_t pdc = 0;
        if (b < 4) {
          int by = 2 * my + (b >> 1), bx = 2 * mx + (b & 1);
          if (bx > 0) pdc = ly[((size_t)by * (2 * nbx) + bx - 1) * 64];
        } else if (mx > 0) {
          pdc = (b == 4 ? lcb : lcr)[((size_t)m - 1) * 64];
        }
        if (!br.get(1)) continue;  // skipped block: dst stays all-zero
        int32_t dc = pdc + br.get_se();
        if (dc < -32768 || dc > 32767) return 4;
        dst[0] = (int16_t)dc;
        int nnz_ac = br.get_ue(), pos = 0;
        for (int t = 0; t < nnz_ac; t++) {
          pos += br.get_ue() + 1;
          if (pos >= 64) return 1;  // corrupt stream
          dst[pos] = (int16_t)br.get_se();
        }
        continue;
      }
      if (!br.get(1)) continue;
      int nnz = br.get_ue() + 1, pos = -1;
      for (int t = 0; t < nnz; t++) {
        pos += br.get_ue() + 1;
        if (pos >= 64) return 1;  // corrupt stream
        dst[pos] = (int16_t)br.get_se();
      }
    }
    if (br.pos > nbits) return 2;
  }
  return 0;
}

// Threaded whole-GOP parse: frame payloads are independent bit streams
// (the per-frame analogue of the reference's threaded demux stage), so a
// GOP parses embarrassingly parallel across std::threads. Arrays are the
// [T, ...]-stacked versions of tvc_parse_frame_planes' outputs.
// blob: concatenated payloads; offsets[t]: byte offset of frame t (T+1
// entries); nbits[t]: payload bit length. Returns 0 or first error code.
int tvc_parse_gop_planes(const uint8_t* blob, const uint64_t* offsets,
                         const uint64_t* nbits, const uint8_t* is_p,
                         const int32_t* base_qp, int T, int nby, int nbx,
                         int16_t* ly, int16_t* lcb, int16_t* lcr,
                         int32_t* mvs, uint8_t* inter, int32_t* qps,
                         int nthreads, int version) {
  size_t n = (size_t)nby * nbx;
  size_t ly_st = 4 * n * 64, lc_st = n * 64;
  std::vector<int> rcs(T, 0);
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int t = next.fetch_add(1);
      if (t >= T) return;
      rcs[t] = tvc_parse_frame_planes(
          blob + offsets[t], nbits[t], is_p[t], base_qp[t], nby, nbx,
          ly + (size_t)t * ly_st, lcb + (size_t)t * lc_st,
          lcr + (size_t)t * lc_st, mvs + (size_t)t * n * 2,
          inter + (size_t)t * n, qps + (size_t)t * n, version);
    }
  };
  if (nthreads < 1) nthreads = 1;
  if (nthreads > T) nthreads = T;
  std::vector<std::thread> threads;
  for (int i = 1; i < nthreads; i++) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  for (int t = 0; t < T; t++)
    if (rcs[t] != 0) return rcs[t];
  return 0;
}

// Parse one frame's payload into per-MB arrays. levels_zz: [nby*nbx*6*64],
// mvs: [nby*nbx*2] (dy, dx), inter: [nby*nbx], qps: [nby*nbx].
// Returns 0 on success.
int tvc_parse_frame(const uint8_t* payload, uint64_t nbits, int is_p,
                    int base_qp, int nby, int nbx, int32_t* levels_zz,
                    int32_t* mvs, uint8_t* inter, int32_t* qps,
                    int version) {
  init_qstep();
  BitReader br(payload, nbits);
  int prev_dx = 0, prev_dy = 0, prev_inter = 0;  // v2 left-MB mv state
  for (int m = 0; m < nby * nbx; m++) {
    int mx = m % nbx;
    bool mb_inter = false;
    int dy = 0, dx = 0;
    if (is_p) {
      if (br.get_ue() == 0) {
        mb_inter = true; dx = br.get_se(); dy = br.get_se();
        if (version >= 2 && mx > 0 && prev_inter) { dx += prev_dx; dy += prev_dy; }
      }
      prev_inter = mb_inter; prev_dx = dx; prev_dy = dy;
    }
    int qp = base_qp + br.get_se();
    qps[m] = qp < 1 ? 1 : (qp > 63 ? 63 : qp);  // corrupt-stream clamp
    int mvr = version >= 4 ? 32 : 16;  // v4: half-pel units (SPEC.md §14.1)
    if (dy < -mvr || dy > mvr || dx < -mvr || dx > mvr) return 3;
    inter[m] = mb_inter;
    mvs[2 * m] = dy;
    mvs[2 * m + 1] = dx;
    int32_t* zz = levels_zz + (size_t)m * 6 * 64;
    memset(zz, 0, 6 * 64 * sizeof(int32_t));
    for (int b = 0; b < 6; b++) {
      if (version >= 2) {
        // DC pred = left block's DC level, read back from levels_zz
        int32_t pdc = 0;
        if (b < 4) {
          // left Y block: b&1 == 1 -> block b-1 of this MB; else block
          // b+1 of the left MB (same block row within the MB)
          if (b & 1) pdc = zz[(b - 1) * 64];
          else if (mx > 0) pdc = levels_zz[((size_t)m - 1) * 6 * 64 + (b + 1) * 64];
        } else if (mx > 0) {
          pdc = levels_zz[((size_t)m - 1) * 6 * 64 + b * 64];
        }
        if (!br.get(1)) continue;
        zz[b * 64] = pdc + br.get_se();
        int nnz_ac = br.get_ue(), pos = 0;
        for (int t = 0; t < nnz_ac; t++) {
          pos += br.get_ue() + 1;
          if (pos >= 64) return 1;  // corrupt stream
          zz[b * 64 + pos] = br.get_se();
        }
        continue;
      }
      if (!br.get(1)) continue;
      int nnz = br.get_ue() + 1, pos = -1;
      for (int t = 0; t < nnz; t++) {
        pos += br.get_ue() + 1;
        if (pos >= 64) return 1;  // corrupt stream
        zz[b * 64 + pos] = br.get_se();
      }
    }
    if (br.pos > nbits) return 2;
  }
  return 0;
}

// Full single-threaded decode of a TVC1 stream to planar I420 frames.
// out must hold nframes * w*h*3/2 bytes; returns frame count or -errno.
int tvc_decode_stream(const uint8_t* data, int64_t size, uint8_t* out,
                      int64_t out_cap) {
  init_qstep();
  if (size < 24 || memcmp(data, "TVC1", 4)) return -1;
  int version = get_le16(&data[4]);
  if (version < 1 || version > 4) return -4;
  int flags = get_le16(&data[6]);
  int cqpo = (flags >> 8) & 0xFF;
  if (cqpo >= 128) cqpo -= 256;  // signed int8 (SPEC.md §12.1)
  bool qmat = version >= 3 && (flags & 2);  // SPEC.md §13.2
  int w = get_le16(&data[8]), h = get_le16(&data[10]);
  uint32_t nframes = get_le32(&data[16]);
  int64_t fsz = (int64_t)w * h * 3 / 2;
  if (out_cap < fsz * nframes) return -2;
  size_t off = 24;
  int islice = 0;
  if (version >= 3) {  // §13.3 header extension word
    if (size < 28) return -3;
    islice = (int)(get_le32(&data[24]) & 0xFFFF);
    off = 28;
  }
  int wp = (w + 15) / 16 * 16, hp = (h + 15) / 16 * 16;
  Plane ry, rcb, rcr;
  ry.w = wp; ry.h = hp; ry.px.assign((size_t)wp * hp, 0);
  rcb.w = wp / 2; rcb.h = hp / 2; rcb.px.assign((size_t)wp * hp / 4, 0);
  rcr = rcb;
  for (uint32_t i = 0; i < nframes; i++) {
    if (off + 8 > (size_t)size) return -3;
    int ftype = data[off];
    int base_qp = data[off + 1];
    uint32_t pbits = get_le32(&data[off + 4]);
    off += 8;
    size_t nbytes = (((uint64_t)pbits + 31) / 32) * 4;  // 64-bit: no wrap
    if (nbytes > (size_t)size || off + nbytes > (size_t)size) return -3;
    decode_frame(w, h, ftype == 1, base_qp, &data[off], pbits, ry, rcb, rcr,
                 version, cqpo, qmat, islice);
    off += nbytes;
    uint8_t* o = out + fsz * i;
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) *o++ = (uint8_t)ry.at(y, x);
    for (int y = 0; y < h / 2; y++)
      for (int x = 0; x < w / 2; x++) *o++ = (uint8_t)rcb.at(y, x);
    for (int y = 0; y < h / 2; y++)
      for (int x = 0; x < w / 2; x++) *o++ = (uint8_t)rcr.at(y, x);
  }
  return (int)nframes;
}

}  // extern "C"

// ------------------------------------------------------------------ main ---
static uint32_t crc32_simple(const std::string& s) {
  // CRC-32 (zlib polynomial), bitwise — matches python zlib.crc32
  uint32_t crc = 0xFFFFFFFFu;
  for (unsigned char c : s) {
    crc ^= c;
    for (int i = 0; i < 8; i++)
      crc = (crc >> 1) ^ (0xEDB88320u & (-(int32_t)(crc & 1)));
  }
  return ~crc;
}

int main(int argc, char** argv) {
  init_qstep();
  if (argc < 3) { fprintf(stderr, "usage: oracle encode|decode ...\n"); return 2; }
  std::string mode = argv[1];

  if (mode == "encode") {
    if (argc < 10) { fprintf(stderr, "encode args\n"); return 2; }
    Config cfg;
    const char* in = argv[2];
    const char* outp = argv[3];
    cfg.w = atoi(argv[4]); cfg.h = atoi(argv[5]);
    cfg.gop = atoi(argv[6]); cfg.qp = atoi(argv[7]);
    {
      std::string s8 = argv[8];
      cfg.search = s8 == "diamond" ? 1 : (s8 == "hier" ? 2 : 0);
    }
    std::string rcs = argv[9];
    cfg.rc = rcs == "adaptive" ? 1
           : (rcs == "bitrate" ? 2
              : (rcs == "vbv" ? 3 : (rcs == "mb" ? 4 : 0)));
    int kbps = argc > 10 ? atoi(argv[10]) : 0;
    cfg.target_bits = kbps > 0 ? kbps * 1000 / 30 : 0;
    int max_frames = argc > 11 ? atoi(argv[11]) : INT32_MAX;
    cfg.fmt = argc > 12 ? atoi(argv[12]) : 1;
    cfg.cqpo = argc > 13 ? atoi(argv[13]) : 0;
    cfg.qbias = argc > 14 ? atoi(argv[14]) : 8;
    int vbv_kbits = argc > 15 ? atoi(argv[15]) : 0;
    cfg.qmat = argc > 16 ? atoi(argv[16]) : 0;
    cfg.islice = argc > 17 ? atoi(argv[17]) : 0;
    cfg.vbv_bits = cfg.rc == 3
        ? (vbv_kbits > 0 ? vbv_kbits * 1000 : 8 * cfg.target_bits) : 0;

    FILE* f = fopen(in, "rb");
    if (!f) { perror("open"); return 1; }
    size_t fsz = (size_t)cfg.w * cfg.h * 3 / 2;
    std::vector<uint8_t> buf(fsz);
    std::vector<FrameOut> outs;
    std::vector<int> ftypes, fqps;
    Plane ry, rcb, rcr;
    int base_qp = cfg.qp;
    int64_t fullness = 0;
    int n = 0;
    auto t0 = std::chrono::steady_clock::now();
    while (n < max_frames && fread(buf.data(), 1, fsz, f) == fsz) {
      int pos = n % cfg.gop;
      bool is_p = pos != 0;
      if (!is_p) {  // RC state resets at GOP boundary
        base_qp = cfg.qp;
        fullness = cfg.vbv_bits / 2;
      }
      Plane cy = pad_to(buf.data(), cfg.w, cfg.h, 16);
      Plane ccb = pad_to(buf.data() + (size_t)cfg.w * cfg.h, cfg.w / 2, cfg.h / 2, 8);
      Plane ccr = pad_to(buf.data() + (size_t)cfg.w * cfg.h * 5 / 4, cfg.w / 2, cfg.h / 2, 8);
      if (!is_p) { ry = cy; rcb = ccb; rcr = ccr; for (auto& v : ry.px) v = 0; for (auto& v : rcb.px) v = 0; for (auto& v : rcr.px) v = 0; }
      FrameOut fo;
      if (cfg.rc == 4) {
        // rc=mb (SPEC.md §10.4): pass 1 probes per-MB bits at the flat
        // frame qp (recon is scratch), pass 2 encodes with row-local pace
        // offsets against the ORIGINAL reference planes
        Plane sy = ry, scb = rcb, scr = rcr;
        FrameOut probe;
        std::vector<int32_t> est;
        encode_frame(cfg, is_p, cy, ccb, ccr, ry, rcb, rcr, base_qp, probe,
                     nullptr, &est);
        ry = sy; rcb = scb; rcr = scr;
        int nby = cy.h / 16, nbx = cy.w / 16;
        std::vector<int32_t> ofs((size_t)nby * nbx, 0);
        for (int my = 0; my < nby; my++) {
          int64_t row_tot = 0;
          for (int mx = 0; mx < nbx; mx++)
            row_tot += est[(size_t)my * nbx + mx];
          if (row_tot < 1) row_tot = 1;
          int64_t spent = 0;
          for (int mx = 0; mx < nbx; mx++) {
            int64_t share = (int64_t)est[(size_t)my * nbx + mx] * 1024 / row_tot;
            int64_t plan = (int64_t)mx * 1024 / nbx;
            int64_t d = (spent - plan) >> 7;  // arithmetic shift == floor/128
            if (d < -2) d = -2; if (d > 2) d = 2;
            ofs[(size_t)my * nbx + mx] = (int32_t)d;
            spent += share;
          }
        }
        encode_frame(cfg, is_p, cy, ccb, ccr, ry, rcb, rcr, base_qp, fo, &ofs);
      } else {
        encode_frame(cfg, is_p, cy, ccb, ccr, ry, rcb, rcr, base_qp, fo);
      }
      ftypes.push_back(is_p ? 1 : 0);
      fqps.push_back(base_qp);
      if ((cfg.rc == 2 || cfg.rc == 4) && cfg.target_bits > 0) {
        // rc=mb frame carry == rc=bitrate (per-MB offsets are intra-frame)
        int64_t t = cfg.target_bits;
        // floor division (Python //), not C truncation: matters when
        // bits < target and the quotient is a small negative
        int64_t num = ((int64_t)fo.bits - t) * 4;
        int64_t d = num / t; if (num % t != 0 && num < 0) d -= 1;
        if (d < -2) d = -2; if (d > 2) d = 2;
        base_qp += (int)d;
        if (base_qp < 1) base_qp = 1; if (base_qp > 63) base_qp = 63;
      } else if (cfg.rc == 3 && cfg.target_bits > 0) {
        // spec.vbv_next verbatim (SPEC.md par.10)
        int64_t t = cfg.target_bits;
        int64_t b = cfg.vbv_bits;
        fullness += t - (int64_t)fo.bits;
        if (fullness < 0) fullness = 0; if (fullness > b) fullness = b;
        int64_t num = ((int64_t)fo.bits - t) * 4;
        int64_t d = num / t; if (num % t != 0 && num < 0) d -= 1;
        if (d < -2) d = -2; if (d > 2) d = 2;
        if (fullness < b / 4) d += 1;
        if (fullness > 3 * b / 4) d -= 1;
        base_qp += (int)d;
        if (base_qp < 1) base_qp = 1; if (base_qp > 63) base_qp = 63;
      }
      outs.push_back(std::move(fo));
      n++;
    }
    fclose(f);
    auto t1 = std::chrono::steady_clock::now();
    double secs = std::chrono::duration<double>(t1 - t0).count();

    // container (SPEC.md §8)
    std::vector<uint8_t> hdr;
    hdr.insert(hdr.end(), {'T', 'V', 'C', '1'});
    put_le16(hdr, (uint16_t)cfg.fmt);
    put_le16(hdr, (uint16_t)((cfg.gop == 1 ? 1 : 0) |
                             ((cfg.fmt >= 3 && cfg.qmat) ? 2 : 0) |
                             ((cfg.fmt >= 2 ? (cfg.cqpo & 0xFF) : 0) << 8)));
    put_le16(hdr, cfg.w); put_le16(hdr, cfg.h);
    put_le16(hdr, cfg.gop);
    hdr.push_back(cfg.qp);
    hdr.push_back((uint8_t)cfg.search);
    put_le32(hdr, n);
    char canon[256];
    int cl = snprintf(canon, sizeof canon,
             "tvc1:w=%d:h=%d:gop=%d:qp=%d:search=%s:rc=%s:kbps=%d:fps=30/1",
             cfg.w, cfg.h, cfg.gop, cfg.qp,
             cfg.search == 1 ? "diamond" : (cfg.search == 2 ? "hier" : "full"),
             cfg.rc == 1 ? "adaptive"
               : (cfg.rc == 2 ? "bitrate"
                  : (cfg.rc == 3 ? "vbv"
                     : (cfg.rc == 4 ? "mb" : "none"))),
             kbps);
    // must mirror EncoderConfig.canonical() exactly (codec/config.py)
    if (cfg.fmt != 1)
      cl += snprintf(canon + cl, sizeof canon - cl, ":v=%d:cqpo=%d",
                     cfg.fmt, cfg.cqpo);
    if (cfg.qbias != 8)
      cl += snprintf(canon + cl, sizeof canon - cl, ":qb=%d", cfg.qbias);
    if (cfg.qmat)
      cl += snprintf(canon + cl, sizeof canon - cl, ":qm=1");
    if (cfg.islice)
      cl += snprintf(canon + cl, sizeof canon - cl, ":is=%d", cfg.islice);
    if (cfg.rc == 3)
      cl += snprintf(canon + cl, sizeof canon - cl, ":vbv=%d", vbv_kbits);
    put_le32(hdr, crc32_simple(canon));
    if (cfg.fmt >= 3)
      put_le32(hdr, (uint32_t)(cfg.islice & 0xFFFF));  // SPEC.md §13.3

    FILE* o = fopen(outp, "wb");
    fwrite(hdr.data(), 1, hdr.size(), o);
    uint64_t total_bits = 0;
    for (int i = 0; i < n; i++) {
      uint8_t fh[8] = {0};
      fh[0] = ftypes[i];
      fh[1] = (uint8_t)fqps[i];
      uint32_t pb = (uint32_t)outs[i].bits;
      memcpy(fh + 4, &pb, 4);  // little-endian on all targets we build for
      fwrite(fh, 1, 8, o);
      fwrite(outs[i].payload.data(), 1, outs[i].payload.size(), o);
      total_bits += outs[i].bits;
    }
    fclose(o);
    fprintf(stderr, "encoded %d frames in %.3fs (%.2f fps), %.1f kbit/frame\n",
            n, secs, n / secs, total_bits / 1000.0 / n);
    printf("{\"frames\": %d, \"fps\": %.2f, \"kbit_per_frame\": %.1f}\n",
           n, n / secs, total_bits / 1000.0 / n);
    return 0;
  }

  if (mode == "decode") {
    if (argc < 4) { fprintf(stderr, "decode args\n"); return 2; }
    FILE* f = fopen(argv[2], "rb");
    if (!f) { perror("open"); return 1; }
    fseek(f, 0, SEEK_END); long sz = ftell(f); fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> data(sz);
    if (fread(data.data(), 1, sz, f) != (size_t)sz) { return 1; }
    fclose(f);
    if (sz < 24 || memcmp(data.data(), "TVC1", 4)) { fprintf(stderr, "bad magic\n"); return 1; }
    int version = get_le16(&data[4]);
    int flags = get_le16(&data[6]);
    int cqpo = (flags >> 8) & 0xFF;
    if (cqpo >= 128) cqpo -= 256;
    bool qmat = version >= 3 && (flags & 2);  // SPEC.md §13.2
    int w = get_le16(&data[8]), h = get_le16(&data[10]);
    uint32_t nframes = get_le32(&data[16]);
    FILE* o = fopen(argv[3], "wb");
    size_t off = 24;
    int islice = 0;
    if (version >= 3) {  // §13.3 header extension word
      if (sz < 28) { fprintf(stderr, "truncated v3 header\n"); return 1; }
      islice = (int)(get_le32(&data[24]) & 0xFFFF);
      off = 28;
    }
    Plane ry, rcb, rcr;
    int wp = (w + 15) / 16 * 16, hp = (h + 15) / 16 * 16;
    ry.w = wp; ry.h = hp; ry.px.assign((size_t)wp * hp, 0);
    rcb.w = wp / 2; rcb.h = hp / 2; rcb.px.assign((size_t)wp * hp / 4, 0);
    rcr = rcb;
    auto t0 = std::chrono::steady_clock::now();
    for (uint32_t i = 0; i < nframes; i++) {
      int ftype = data[off];
      int base_qp = data[off + 1];
      uint32_t pbits = get_le32(&data[off + 4]);
      off += 8;
      size_t nbytes = ((pbits + 31) / 32) * 4;
      decode_frame(w, h, ftype == 1, base_qp, &data[off], pbits, ry, rcb, rcr,
                 version, cqpo, qmat, islice);
      off += nbytes;
      // crop + write
      std::vector<uint8_t> yout((size_t)w * h), cbout((size_t)w * h / 4), crout((size_t)w * h / 4);
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) yout[(size_t)y * w + x] = (uint8_t)ry.at(y, x);
      for (int y = 0; y < h / 2; y++)
        for (int x = 0; x < w / 2; x++) {
          cbout[(size_t)y * (w / 2) + x] = (uint8_t)rcb.at(y, x);
          crout[(size_t)y * (w / 2) + x] = (uint8_t)rcr.at(y, x);
        }
      fwrite(yout.data(), 1, yout.size(), o);
      fwrite(cbout.data(), 1, cbout.size(), o);
      fwrite(crout.data(), 1, crout.size(), o);
    }
    fclose(o);
    auto t1 = std::chrono::steady_clock::now();
    double secs = std::chrono::duration<double>(t1 - t0).count();
    fprintf(stderr, "decoded %u frames in %.3fs (%.2f fps)\n", nframes, secs, nframes / secs);
    printf("{\"frames\": %u, \"fps\": %.2f}\n", nframes, nframes / secs);
    return 0;
  }

  fprintf(stderr, "unknown mode %s\n", mode.c_str());
  return 2;
}
