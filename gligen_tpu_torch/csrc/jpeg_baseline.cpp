// A baseline JPEG decoder with no library behind it (ITU-T T.81), host code
// of the data path (gligen_tpu_torch/data/jpeg.py binds it with ctypes).
//
// What it decodes: SOF0 and SOF1 frames (8-bit samples, Huffman coding),
// one or three components with sampling factors of 1 or 2 (4:4:4, 4:2:2,
// 4:2:0, 4:4:0), interleaved or one component a scan, 8- and 16-bit DQT,
// any number of DHT/DQT segments, DRI restart intervals; APPn and COM
// segments are skipped (EXIF orientation is not applied).  Progressive,
// lossless, hierarchical and arithmetic-coded frames, 12-bit samples, four
// components (CMYK/YCCK), a corrupt or truncated stream: an error that names
// the feature.
//
// The pixels are libjpeg-turbo's as PIL calls it (JDCT_ISLOW, fancy
// upsampling on), bit for bit:
//   * the accurate integer IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2)
//     with the post-IDCT range-limit table of jdmaster.c;
//   * the upsampling of jdsample.c: h2v1 and h2v2 "fancy" (triangle) filters
//     when the downsampled width exceeds 2, else box replication; h1v2
//     fancy always; context rows past the top and bottom edges replicate the
//     first and last real rows (jdmainct.c), columns past the edges the
//     first and last real columns; the biases +1/+2 (h2v1, h1v2) and
//     +8/+7 (h2v2);
//   * the YCbCr -> RGB tables of jdcolor.c (16-bit fixed point);
//   * the colour space jpeg_read_header guesses: JFIF -> YCbCr, else an
//     Adobe APP14 transform (0 -> RGB, else YCbCr), else component ids
//     'R','G','B' -> RGB, else YCbCr.
//
// No global state: every call owns its decoder, so threads and forked
// workers decode at once.
//
// C ABI:
//   jpeg_baseline_info(data, len, info[3] = {width, height, channels}, err, errlen)
//   jpeg_baseline_decode(data, len, out, cap, err, errlen)  -> H x W x channels
// Both return 0, or 1 with a message in err.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct DecodeError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError{msg}; }

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valptr[17] = {};
  int32_t mincode[17] = {};
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | value, 0: longer code

  void build(const uint8_t counts[16], const uint8_t* symbols, int n, bool dc) {
    std::memcpy(vals, symbols, n);
    int code = 0, k = 0;
    std::memset(look, 0, sizeof(look));
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < counts[l - 1]; ++i) {
        if (l <= kLookBits) {
          int lo = code << (kLookBits - l), hi = (code + 1) << (kLookBits - l);
          for (int j = lo; j < hi; ++j) look[j] = uint16_t((l << 8) | vals[k]);
        }
        ++code;
        ++k;
      }
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      // no code may be all ones (jdhuff.c jpeg_make_d_derived_tbl)
      if (code >= (1 << l)) fail("corrupt JPEG: bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    if (dc)
      for (int i = 0; i < n; ++i)
        if (vals[i] > 15) fail("corrupt JPEG: bad DC Huffman table");
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int dw = 0, dh = 0;         // real (downsampled) size
  int bw = 0, bh = 0;         // blocks in the plane
  std::vector<uint8_t> plane; // bh * 8 rows of bw * 8 samples
  int pred = 0;
  bool decoded = false;
};

// Entropy-coded bits.  Past a marker, or the end of the data, zero bits
// are fed in; a decode that consumes one of them is a truncated stream.
struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos;
  uint64_t acc = 0;
  int cnt = 0;      // bits in acc
  int pad = 0;      // of them, zero bits fed past the data (at the low end)
  bool at_marker = false;

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!at_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          uint32_t b2 = pos + 1 < n ? d[pos + 1] : 0xFF;
          if (b2 == 0) {
            pos += 2;
          } else {
            at_marker = true;
            b = 0;
          }
        } else {
          ++pos;
        }
      } else {
        at_marker = true;
      }
      if (at_marker) pad += 8;
      acc |= uint64_t(b) << (56 - cnt);
      cnt += 8;
    }
  }
  void consume(int k) {
    acc <<= k;
    cnt -= k;
    if (cnt < pad) fail("truncated JPEG: the entropy-coded data ends early");
  }
  int bits(int s) {
    if (s == 0) return 0;
    fill();
    int v = int(acc >> (64 - s));
    consume(s);
    return v;
  }
  int decode(const Huffman& t) {
    fill();
    uint16_t e = t.look[acc >> (64 - kLookBits)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      int32_t code = int32_t(acc >> (64 - l));
      if (code <= t.maxcode[l]) {
        consume(l);
        return t.vals[t.valptr[l] + code - t.mincode[l]];
      }
    }
    fail("corrupt JPEG: bad Huffman code");
  }
  // drop the bits of a finished restart interval, then expect RSTn
  void restart(int expect) {
    acc = 0;
    cnt = pad = 0;
    at_marker = false;
    while (pos < n && d[pos] != 0xFF) ++pos;  // leftover padding bytes
    while (pos + 1 < n && d[pos] == 0xFF && d[pos + 1] == 0xFF) ++pos;
    if (pos + 1 >= n || d[pos + 1] != 0xD0 + expect)
      fail("corrupt JPEG: missing restart marker");
    pos += 2;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ---- jidctint.c, jpeg_idct_islow -------------------------------------------
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (int32_t(1) << (n - 1))) >> n; }

// jdmaster.c's post-IDCT range limit: the centred sample masked to 10 bits
inline uint8_t range_limit(int32_t x) {
  int i = x & 1023;
  if (i < 128) return uint8_t(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return uint8_t(i - 896);
}

void idct_islow(const int16_t* coef, const int16_t* quant, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int16_t* q = quant + c;
    int32_t* w = ws + c;
    auto dq = [&](int r) { return int32_t(in[8 * r]) * int32_t(q[8 * r]); };
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int32_t dc = dq(0) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int32_t z2 = dq(2), z3 = dq(6);
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = dq(0);
    z3 = dq(4);
    int32_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int32_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = dq(7);
    tmp1 = dq(5);
    tmp2 = dq(3);
    tmp3 = dq(1);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    w[0] = descale(tmp10 + tmp3, sh);
    w[56] = descale(tmp10 - tmp3, sh);
    w[8] = descale(tmp11 + tmp2, sh);
    w[48] = descale(tmp11 - tmp2, sh);
    w[16] = descale(tmp12 + tmp1, sh);
    w[40] = descale(tmp12 - tmp1, sh);
    w[24] = descale(tmp13 + tmp0, sh);
    w[32] = descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t dc = range_limit(descale(w[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (w[0] + w[4]) * (1 << CONST_BITS);
    int32_t tmp1 = (w[0] - w[4]) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    o[0] = range_limit(descale(tmp10 + tmp3, sh));
    o[7] = range_limit(descale(tmp10 - tmp3, sh));
    o[1] = range_limit(descale(tmp11 + tmp2, sh));
    o[6] = range_limit(descale(tmp11 - tmp2, sh));
    o[2] = range_limit(descale(tmp12 + tmp1, sh));
    o[5] = range_limit(descale(tmp12 - tmp1, sh));
    o[3] = range_limit(descale(tmp13 + tmp0, sh));
    o[4] = range_limit(descale(tmp13 - tmp0, sh));
  }
}

// ---- the decoder -------------------------------------------------------------
struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  Component comp[3];
  int16_t quant[4][64] = {};  // natural order, as ISLOW_MULT_TYPE (short)
  bool quant_defined[4] = {};
  Huffman dc[4], ac[4];

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

  int u8() {
    if (pos >= n) fail("truncated JPEG: the data ends inside a marker segment");
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // the next marker's code (fill bytes skipped), or -1 at the end of the data
  int next_marker() {
    while (pos < n && d[pos] != 0xFF) ++pos;  // garbage between segments
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) return -1;
    return d[pos++];
  }

  void unsupported_frame(int m) {
    switch (m) {
      case 0xC2: fail("progressive JPEG (SOF2) is not supported");
      case 0xC3: fail("lossless JPEG (SOF3) is not supported");
      case 0xC5: case 0xC6: case 0xC7:
        fail("hierarchical (differential) JPEG (SOF" + std::to_string(m - 0xC0) +
             ") is not supported");
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        fail("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) + ") is not supported");
      default: fail("corrupt JPEG: unknown frame marker");
    }
  }

  void read_sof() {
    int len = u16();
    size_t end = pos + len - 2;
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit samples are not supported (8-bit only)");
    if (height == 0) fail("a JPEG whose height comes in a DNL marker is not supported");
    if (width == 0) fail("corrupt JPEG: zero width");
    if (ncomp == 4) fail("CMYK/YCCK JPEG (4 components) is not supported");
    if (ncomp != 1 && ncomp != 3)
      fail("a JPEG of " + std::to_string(ncomp) + " components is not supported");
    if (len != 8 + 3 * ncomp) fail("corrupt JPEG: bad SOF length");
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("corrupt JPEG: bad sampling factors or quantization table");
      if (c.h > 2 || c.v > 2)
        fail("sampling factors above 2 (" + std::to_string(c.h) + "x" + std::to_string(c.v) +
             ") are not supported");
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    int mcux = (width + 8 * hmax - 1) / (8 * hmax), mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.plane.assign(size_t(c.bw) * 8 * size_t(c.bh) * 8, 0);
    }
    pos = end;
    frame = true;
  }

  void read_dqt() {
    int len = u16();
    size_t end = pos + len - 2;
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) fail("corrupt JPEG: bad DQT");
      for (int k = 0; k < 64; ++k) {
        int q = pq ? u16() : u8();
        quant[tq][kZigzag[k]] = int16_t(q);
      }
      quant_defined[tq] = true;
    }
    if (pos != end) fail("corrupt JPEG: bad DQT length");
  }

  void read_dht() {
    int len = u16();
    size_t end = pos + len - 2;
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG: bad DHT");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = uint8_t(u8());
      if (total > 256 || pos + total > end) fail("corrupt JPEG: bad Huffman table");
      (tc ? ac[th] : dc[th]).build(counts, d + pos, total, tc == 0);
      pos += total;
    }
    if (pos != end) fail("corrupt JPEG: bad DHT length");
  }

  void read_app(int m) {
    int len = u16();
    if (len < 2) fail("corrupt JPEG: bad segment length");
    size_t end = pos + len - 2;
    if (end > n) fail("truncated JPEG: the data ends inside a marker segment");
    // jdmarker.c: APP0 "JFIF\0" of at least 14 bytes, APP14 "Adobe" of at least 12
    if (m == 0xE0 && len >= 16 && !std::memcmp(d + pos, "JFIF\0", 5)) jfif = true;
    if (m == 0xEE && len >= 14 && !std::memcmp(d + pos, "Adobe", 5)) {
      adobe = true;
      adobe_transform = d[pos + 11];
    }
    pos = end;
  }

  void skip_segment() {
    int len = u16();
    if (len < 2) fail("corrupt JPEG: bad segment length");
    pos += len - 2;
    if (pos > n) fail("truncated JPEG: the data ends inside a marker segment");
  }

  // markers up to and including the frame header (info only)
  void read_header() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG (no SOI marker)");
    pos = 2;
    while (!frame) {
      int m = next_marker();
      if (m < 0) fail("truncated JPEG: no frame header");
      dispatch(m);
      if (m == 0xDA) fail("corrupt JPEG: a scan before the frame header");
    }
  }

  // one marker segment; returns false at EOI
  bool dispatch(int m) {
    if (m == 0xC0 || m == 0xC1) {
      if (frame) fail("corrupt JPEG: two frame headers");
      read_sof();
    } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      unsupported_frame(m);
    } else if (m == 0xCC) {
      fail("arithmetic-coded JPEG (DAC) is not supported");
    } else if (m == 0xC4) {
      read_dht();
    } else if (m == 0xDB) {
      read_dqt();
    } else if (m == 0xDD) {
      if (u16() != 4) fail("corrupt JPEG: bad DRI length");
      restart_interval = u16();
    } else if (m == 0xDC) {
      fail("a JPEG whose height comes in a DNL marker is not supported");
    } else if (m >= 0xE0 && m <= 0xEF) {
      read_app(m);
    } else if (m == 0xD9) {
      return false;
    } else if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      // stray SOI, RSTn or TEM: no segment
    } else if (m == 0xDA) {
      read_scan();
    } else {
      skip_segment();  // COM and anything else with a length
    }
    return true;
  }

  void decode_block(BitReader& br, Component& c, int bx, int by, int16_t* coef) {
    std::memset(coef, 0, 64 * sizeof(int16_t));
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int s = br.decode(hd);
    if (s > 11) fail("corrupt JPEG: bad DC coefficient");
    c.pred += s ? extend(br.bits(s), s) : 0;
    coef[0] = int16_t(c.pred);
    for (int k = 1; k < 64;) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt JPEG: AC coefficients past the block");
        coef[kZigzag[k]] = int16_t(extend(br.bits(s), s));
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;
      }
    }
    int stride = c.bw * 8;
    idct_islow(coef, quant[c.tq], c.plane.data() + size_t(by) * 8 * stride + size_t(bx) * 8,
               stride);
  }

  void read_scan() {
    if (!frame) fail("corrupt JPEG: a scan before the frame header");
    int len = u16();
    int ns = u8();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns) fail("corrupt JPEG: bad scan header");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (!c) fail("corrupt JPEG: a scan names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined)
        fail("corrupt JPEG: a scan uses an undefined Huffman table");
      if (!quant_defined[c->tq]) fail("corrupt JPEG: a component's DQT is missing");
      sc[i] = c;
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) fail("corrupt JPEG: bad spectral selection");
    for (int i = 0; i < ns; ++i) sc[i]->pred = 0;

    BitReader br{d, n, pos};
    int16_t coef[64];
    int mcux, mcuy;
    if (ns == 1) {  // non-interleaved: one block an MCU over the real size
      mcux = (sc[0]->dw + 7) / 8;
      mcuy = (sc[0]->dh + 7) / 8;
    } else {
      mcux = (width + 8 * hmax - 1) / (8 * hmax);
      mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    }
    long done = 0;
    int next_rst = 0;
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        if (restart_interval && done && done % restart_interval == 0) {
          br.restart(next_rst);
          next_rst = (next_rst + 1) & 7;
          for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        }
        if (ns == 1) {
          decode_block(br, *sc[0], mx, my, coef);
        } else {
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) decode_block(br, c, mx * c.h + x, my * c.v + y, coef);
          }
        }
        ++done;
      }
    }
    for (int i = 0; i < ns; ++i) sc[i]->decoded = true;
    // resume at the marker after the entropy-coded data
    pos = br.pos;
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0 && d[pos + 1] != 0xFF)) ++pos;
  }

  void decode(uint8_t* out, int64_t cap) {
    read_header();
    int channels = ncomp == 1 ? 1 : 3;
    if (int64_t(width) * height * channels > cap) fail("output buffer too small");
    for (;;) {
      int m = next_marker();
      if (m < 0 || !dispatch(m)) break;
    }
    for (int i = 0; i < ncomp; ++i)
      if (!comp[i].decoded) fail("truncated JPEG: a component has no scan");
    if (ncomp == 1) {
      const Component& c = comp[0];
      for (int y = 0; y < height; ++y)
        std::memcpy(out + size_t(y) * width, c.plane.data() + size_t(y) * c.bw * 8, width);
      return;
    }
    std::vector<uint8_t> full[3];
    for (int i = 0; i < 3; ++i) full[i] = upsample(comp[i]);
    bool rgb = false;
    if (jfif) {
      rgb = false;
    } else if (adobe) {
      rgb = adobe_transform == 0;
    } else {
      rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
    }
    size_t npix = size_t(width) * height;
    if (rgb) {
      for (size_t p = 0; p < npix; ++p)
        for (int i = 0; i < 3; ++i) out[3 * p + i] = full[i][p];
      return;
    }
    ycc_to_rgb(full, out, npix);
  }

  // jdcolor.c build_ycc_rgb_table + ycc_rgb_convert
  static void ycc_to_rgb(std::vector<uint8_t> full[3], uint8_t* out, size_t npix) {
    const int SCALEBITS = 16;
    const int32_t ONE_HALF = int32_t(1) << (SCALEBITS - 1);
    auto FIX = [](double x) { return int32_t(x * (1L << 16) + 0.5); };
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = int((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = int((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -FIX(0.71414) * x;
      cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    const uint8_t *Y = full[0].data(), *Cb = full[1].data(), *Cr = full[2].data();
    for (size_t p = 0; p < npix; ++p) {
      int y = Y[p], cb = Cb[p], cr = Cr[p];
      out[3 * p] = clamp(y + cr_r[cr]);
      out[3 * p + 1] = clamp(y + int((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
      out[3 * p + 2] = clamp(y + cb_b[cb]);
    }
  }

  // jdsample.c: the component at the image's full size
  std::vector<uint8_t> upsample(const Component& c) const {
    std::vector<uint8_t> o(size_t(width) * height);
    const int hr = hmax / c.h, vr = vmax / c.v, stride = c.bw * 8;
    const int dw = c.dw, dh = c.dh;
    auto px = [&](int y, int x) { return int(c.plane[size_t(y) * stride + x]); };
    auto row_clamp = [&](int y) { return y < 0 ? 0 : y >= dh ? dh - 1 : y; };
    auto col_clamp = [&](int x) { return x < 0 ? 0 : x >= dw ? dw - 1 : x; };
    const bool fancy_h = hr == 2 && dw > 2;
    for (int y = 0; y < height; ++y) {
      uint8_t* orow = o.data() + size_t(y) * width;
      if (vr == 1 && hr == 1) {
        std::memcpy(orow, c.plane.data() + size_t(y) * stride, width);
      } else if (vr == 1 && fancy_h) {  // h2v1 fancy
        for (int x = 0; x < width; ++x) {
          int ix = x >> 1, cur = 3 * px(y, ix);
          orow[x] = uint8_t((x & 1) ? (cur + px(y, col_clamp(ix + 1)) + 2) >> 2
                                    : (cur + px(y, col_clamp(ix - 1)) + 1) >> 2);
        }
      } else if (vr == 2 && hr == 1) {  // h1v2 fancy
        int near = y >> 1, lower = y & 1;
        int far = row_clamp(lower ? near + 1 : near - 1);
        int bias = lower ? 2 : 1;
        for (int x = 0; x < width; ++x)
          orow[x] = uint8_t((3 * px(near, x) + px(far, x) + bias) >> 2);
      } else if (vr == 2 && fancy_h) {  // h2v2 fancy
        int near = y >> 1, far = row_clamp((y & 1) ? near + 1 : near - 1);
        auto colsum = [&](int ix) { return 3 * px(near, ix) + px(far, ix); };
        for (int x = 0; x < width; ++x) {
          int ix = x >> 1, cur = 3 * colsum(ix);
          orow[x] = uint8_t((x & 1) ? (cur + colsum(col_clamp(ix + 1)) + 7) >> 4
                                    : (cur + colsum(col_clamp(ix - 1)) + 8) >> 4);
        }
      } else {  // box replication (h2v1 / h2v2 at a downsampled width of 2 or less)
        int iy = y / vr;
        for (int x = 0; x < width; ++x) orow[x] = uint8_t(px(iy, x / hr));
      }
    }
    return o;
  }
};

int report(const DecodeError& e, char* err, int32_t errlen) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", e.msg.c_str());
  return 1;
}

}  // namespace

extern "C" {

int jpeg_baseline_info(const uint8_t* data, int64_t len, int32_t* info, char* err,
                       int32_t errlen) {
  try {
    Decoder dec(data, size_t(len));
    dec.read_header();
    info[0] = dec.width;
    info[1] = dec.height;
    info[2] = dec.ncomp == 1 ? 1 : 3;
    return 0;
  } catch (const DecodeError& e) {
    return report(e, err, errlen);
  } catch (...) {
    return report(DecodeError{"JPEG decode failed (out of memory?)"}, err, errlen);
  }
}

int jpeg_baseline_decode(const uint8_t* data, int64_t len, uint8_t* out, int64_t cap, char* err,
                         int32_t errlen) {
  try {
    Decoder dec(data, size_t(len));
    dec.decode(out, cap);
    return 0;
  } catch (const DecodeError& e) {
    return report(e, err, errlen);
  } catch (...) {
    return report(DecodeError{"JPEG decode failed (out of memory?)"}, err, errlen);
  }
}

}  // extern "C"
