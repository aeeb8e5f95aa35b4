// The port's JPEG codec and PNG row unfilter: host C++17, no library
// beyond libc/libstdc++, a plain C interface for ctypes (utils/jpeg.py,
// utils/image_io.py). Every function returns a code and never aborts or
// prints.
//
// The arithmetic is libjpeg's (as libjpeg-turbo, which OpenCV bundles,
// computes it), step for step, so that decodes equal cv2.imdecode's and
// encodes equal cv2.imwrite's bit for bit:
//   decode  jdmarker.c's marker reading, jdhuff.c's entropy decoding with
//           its recovery from corrupt data (zero bits after a marker met too
//           early, gray blocks for the rest of the restart interval,
//           jpeg_resync_to_restart; the standard tables for a table 0 or 1
//           that no DHT defined), jidctint.c's "islow" IDCT as
//           libjpeg-turbo's x86 SIMD computes it, jdsample.c's fancy
//           upsampling (h2v1, h1v2,
//           h2v2 triangle filters with their alternating rounding biases;
//           box upsampling where libjpeg uses it), jdcolor.c's fixed-point
//           YCbCr -> RGB tables and its grey conversions;
//   encode  cv2.imwrite(".jpg") at OpenCV's defaults: baseline, 4:2:0 for
//           colour (one component for grey), the Annex K Huffman tables, no
//           optimisation, no restarts, a JFIF APP0; jccolor.c's RGB -> YCbCr,
//           jcsample.c's h2v2 downsampling with its 1, 2 bias, edge
//           replication and jccoefct.c's dummy blocks, jfdctint.c's forward
//           DCT and jcdctmgr.c's reciprocal quantisation.
// Decoded: baseline and extended sequential Huffman (SOF0/SOF1), 8-bit,
// one or three components, any sampling factors with integral ratios,
// DQT/DHT anywhere, restart intervals, APPn/COM skipped. Progressive,
// lossless, hierarchical, arithmetic-coded, 12-bit and 2- or 4-component
// files give a code of their own (utils/jpeg.py raises naming the mode).
// A file whose data ends before its last MCU (or, for a file of several
// scans, before its EOI) gives kTruncated: OpenCV's in-memory source
// suspends there and cv2.imdecode returns None.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum Code : int {
  kOk = 0,
  kTruncated = 1,    // the data ends before EOI
  kCorrupt = 2,      // libjpeg would stop with an error
  kBadArgs = 3,      // a buffer or size the caller passed does not fit
  kTooLarge = 4,     // above OpenCV's kMaxPixels: cv2.imdecode raises
  kProgressive = 10,
  kLossless = 11,
  kArithmetic = 12,
  kHierarchical = 13,
  kPrecision = 14,   // not 8 bits a sample
  kComponents = 15,  // not 1 or 3 components
};

// CV_IO_MAX_IMAGE_PIXELS, which OpenCV's validateInputImageSize asserts
// once the header is read
const int64_t kMaxPixels = int64_t(1) << 30;

struct Fail {
  int code;
};

[[noreturn]] void fail(int code) { throw Fail{code}; }

// zigzag position -> natural (row-major) position; the 16 extra entries
// absorb the run lengths of corrupt data (jutils.c jpeg_natural_order)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int32_t fix16(double x) { return (int32_t)(x * 65536.0 + 0.5); }

// ----------------------------------------------------------------- tables

struct Tables {
  // jdcolor.c build_ycc_rgb_table
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  // jdcolor.c build_rgb_y_table and jccolor.c rgb_ycc_start (8 sections)
  int32_t rgb_ycc[8 * 256];

  Tables() {
    for (int i = 0; i < 256; i++) {
      int x = i - 128;
      cr_r[i] = (int)((fix16(1.40200) * x + (1 << 15)) >> 16);
      cb_b[i] = (int)((fix16(1.77200) * x + (1 << 15)) >> 16);
      cr_g[i] = -fix16(0.71414) * x;
      cb_g[i] = -fix16(0.34414) * x + (1 << 15);
      rgb_ycc[0 * 256 + i] = fix16(0.29900) * i;
      rgb_ycc[1 * 256 + i] = fix16(0.58700) * i;
      rgb_ycc[2 * 256 + i] = fix16(0.11400) * i + (1 << 15);
      rgb_ycc[3 * 256 + i] = -fix16(0.16874) * i;
      rgb_ycc[4 * 256 + i] = -fix16(0.33126) * i;
      // B => Cb and R => Cr are the same table; the 0.5 - epsilon fudge
      rgb_ycc[5 * 256 + i] = fix16(0.50000) * i + (128 << 16) + (1 << 15) - 1;
      rgb_ycc[6 * 256 + i] = -fix16(0.41869) * i;
      rgb_ycc[7 * 256 + i] = -fix16(0.08131) * i;
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ------------------------------------------------------------- byte input

struct Src {
  const uint8_t* p;
  const uint8_t* end;

  int byte() {
    if (p >= end) fail(kTruncated);
    return *p++;
  }
  int u16() {
    int a = byte();
    return (a << 8) | byte();
  }
  void skip(long n) {
    if (n <= 0) return;
    if (n > end - p) fail(kTruncated);
    p += n;
  }
  // jdmarker.c next_marker: discard bytes up to an 0xFF, swallow fill
  // 0xFFs, and go on past FF 00 (a stuffed data byte)
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte();
      while (c == 0xFF);
      if (c != 0) return c;
    }
  }
};

// ---------------------------------------------------------------- Huffman

constexpr int kLook = 9;  // bits of the lookup table

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t val[256] = {};
};

struct HuffDec {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t val[256];
  uint16_t look[1 << kLook];  // (length << 8) | symbol, 0 for longer codes
  // AC tables: a code and its extra bits within kLook bits, decoded whole:
  // (value << 8) | (run << 4) | bits used; 0 where that does not fit
  int32_t fast_ac[1 << kLook];
};

// jdhuff.c jpeg_make_d_derived_tbl, with its checks
void derive(const HuffSpec& s, bool dc, HuffDec& d) {
  uint8_t size[257];
  uint32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int i = s.bits[l];
    if (p + i > 256) fail(kCorrupt);
    while (i--) size[p++] = (uint8_t)l;
  }
  size[p] = 0;
  const int num = p;
  uint32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if (code >= (1u << si)) fail(kCorrupt);  // a code of all ones
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (s.bits[l]) {
      d.valoffset[l] = p - (int32_t)code_of[p];
      p += s.bits[l];
      d.maxcode[l] = (int32_t)code_of[p - 1];
    } else {
      d.maxcode[l] = -1;
    }
  }
  d.valoffset[17] = 0;
  d.maxcode[17] = 0xFFFFF;  // ends the bit-serial search at 17 bits
  std::memcpy(d.val, s.val, 256);
  std::memset(d.look, 0, sizeof d.look);
  p = 0;
  for (int l = 1; l <= kLook; l++) {
    for (int i = 0; i < s.bits[l]; i++, p++) {
      const int base = (int)code_of[p] << (kLook - l);
      for (int j = 0; j < (1 << (kLook - l)); j++)
        d.look[base + j] = (uint16_t)((l << 8) | s.val[p]);
    }
  }
  if (dc) {
    for (int i = 0; i < num; i++)
      if (s.val[i] > 15) fail(kCorrupt);
  }
  for (int i = 0; i < (1 << kLook); i++) {
    d.fast_ac[i] = 0;
    const int e = d.look[i];
    if (!e) continue;
    const int len = e >> 8, run = (e >> 4) & 15, extra = e & 15;
    if (!extra || len + extra > kLook) continue;
    const int r = (i >> (kLook - len - extra)) & ((1 << extra) - 1);
    const int v = r < (1 << (extra - 1)) ? r - (1 << extra) + 1 : r;
    d.fast_ac[i] = (int32_t)((uint32_t)v << 8) | (run << 4) | (len + extra);
  }
}

// The entropy-coded bits of a scan. Where a marker ends the data, zero
// bits follow, as libjpeg inserts them; `insufficient` records that one of
// them was used (libjpeg's insufficient_data), after which the rest of the
// restart interval decodes as zero blocks.
struct Bits {
  Src* s;
  uint64_t buf = 0;  // left-aligned
  int cnt = 0;       // bits in buf
  int real = 0;      // of which came from the data (a prefix)
  int marker = 0;    // the marker met (libjpeg's unread_marker), or 0
  bool insufficient = false;

  void fill() {
    const uint8_t* p = s->p;
    const uint8_t* const end = s->end;
    while (cnt <= 56) {
      if (marker) {
        cnt += 8;
        continue;
      }
      if (p >= end) fail(kTruncated);
      int c = *p++;
      if (c == 0xFF) {
        int c2;
        do {
          if (p >= end) fail(kTruncated);
          c2 = *p++;
        } while (c2 == 0xFF);
        if (c2 != 0) {
          marker = c2;
          cnt += 8;
          continue;
        }
      }
      buf |= (uint64_t)c << (56 - cnt);
      cnt += 8;
      real += 8;
    }
    s->p = p;
  }
  void drop() {
    buf = 0;
    cnt = 0;
    real = 0;
  }
  void skip(int n) {
    buf <<= n;
    cnt -= n;
    if (n > real) {
      insufficient = true;
      real = 0;
    } else {
      real -= n;
    }
  }
  // a symbol and then its extra bits: 16 + 15 bits at most, so one fill
  // before the symbol serves both
  int decode(const HuffDec& h) {
    if (cnt < 32) fill();
    const int e = h.look[buf >> (64 - kLook)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int l = kLook + 1;
    int32_t code = (int32_t)(buf >> (64 - l));
    while (code > h.maxcode[l]) {
      l++;
      code = (int32_t)(buf >> (64 - l));
    }
    skip(l);
    if (l > 16) return 0;  // jpeg_huff_decode's "fake a zero"
    return h.val[(code + h.valoffset[l]) & 0xFF];
  }
  int extend(int n) {  // receive n bits and sign-extend (HUFF_EXTEND)
    const int r = (int)(buf >> (64 - n));
    skip(n);
    return r < (1 << (n - 1)) ? r - (1 << n) + 1 : r;
  }
};

// Annex K.3 tables (jcparam.c std_huff_tables, jstdhuff.c): bits[1..16],
// then values. The encoder writes them; the decoder falls back on them for
// a table 0 or 1 that no DHT defined, as libjpeg-turbo does for Motion-JPEG
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ----------------------------------------------------------------- decode

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc = 0, ac = 0;      // Huffman table numbers of the current scan
  int wib = 0, hib = 0;    // width and height in blocks
  int dw = 0, dh = 0;      // downsampled width and height
  int bw = 0, bh = 0;      // blocks stored: whole MCUs of an interleaved scan
  std::vector<int16_t> coef;
  bool latched = false;
  int16_t q[64] = {};      // the quantisation table, latched at its first scan
  std::vector<uint8_t> plane;  // wib * 8 by hib * 8 samples after the IDCT
};

inline int32_t descale(int64_t x, int n) { return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n); }

// jidctint.c jpeg_idct_islow, as libjpeg-turbo's x86 SIMD version (the one
// OpenCV's build runs) computes it: dequantised coefficients and the sums
// in0 +- in4, in7 + in3, in5 + in1 wrap at 16 bits, products and sums at
// 32, the first pass saturates to 16 bits and the output to [0, 255]; a
// block whose rows 1-7 are zero takes the first pass's shortcut (the row-0
// coefficient times its quantiser, << 2, at 16 bits). On coefficients of a
// valid stream this is the C routine's arithmetic bit for bit; the wraps
// and saturations decide only what corrupt data decodes to.
inline int16_t w16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
inline int16_t sat16(int32_t x) { return (int16_t)std::min(std::max(x, -32768), 32767); }
inline int32_t add32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
inline int32_t sub32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }
inline int32_t mad(int16_t a, int32_t ca, int16_t b, int32_t cb) { return a * ca + b * cb; }  // pmaddwd

// one 1-D pass over eight lanes at once: in[8 * k + c] is frequency k of
// lane c, out[8 * k + c] sample k of lane c, descaled by `shift` (written
// lane-parallel, so that the compiler vectorises it)
inline void idct_pass(const int16_t* in, int shift, int32_t* out) {
  constexpr int F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                F2562 = 20995, F3072 = 25172;
  const int32_t r = 1 << (shift - 1);
  for (int c = 0; c < 8; c++) {
    const int16_t in0 = in[c], in1 = in[8 + c], in2 = in[16 + c], in3 = in[24 + c],
                  in4 = in[32 + c], in5 = in[40 + c], in6 = in[48 + c], in7 = in[56 + c];
    // even part
    const int32_t tmp3e = mad(in2, F0541 + F0765, in6, F0541);
    const int32_t tmp2e = mad(in2, F0541, in6, F0541 - F1847);
    const int32_t tmp0e = (int32_t)((uint32_t)(int32_t)w16(in0 + in4) << 13);
    const int32_t tmp1e = (int32_t)((uint32_t)(int32_t)w16(in0 - in4) << 13);
    const int32_t t10 = add32(tmp0e, tmp3e), t13 = sub32(tmp0e, tmp3e);
    const int32_t t11 = add32(tmp1e, tmp2e), t12 = sub32(tmp1e, tmp2e);
    // odd part
    const int16_t z3 = w16(in7 + in3), z4 = w16(in5 + in1);
    const int32_t z3m = mad(z3, F1175 - F1961, z4, F1175);
    const int32_t z4m = mad(z3, F1175, z4, F1175 - F0390);
    const int32_t tmp0 = add32(mad(in7, F0298 - F0899, in1, -F0899), z3m);
    const int32_t tmp3 = add32(mad(in7, -F0899, in1, F1501 - F0899), z4m);
    const int32_t tmp1 = add32(mad(in5, F2053 - F2562, in3, -F2562), z4m);
    const int32_t tmp2 = add32(mad(in5, -F2562, in3, F3072 - F2562), z3m);
    out[c] = add32(add32(t10, tmp3), r) >> shift;
    out[56 + c] = add32(sub32(t10, tmp3), r) >> shift;
    out[8 + c] = add32(add32(t11, tmp2), r) >> shift;
    out[48 + c] = add32(sub32(t11, tmp2), r) >> shift;
    out[16 + c] = add32(add32(t12, tmp1), r) >> shift;
    out[40 + c] = add32(sub32(t12, tmp1), r) >> shift;
    out[24 + c] = add32(add32(t13, tmp0), r) >> shift;
    out[32 + c] = add32(sub32(t13, tmp0), r) >> shift;
  }
}

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int16_t dq[64], ws[64], wt[64];
  int32_t o[64];
  bool ac = false;
  for (int i = 8; i < 64 && !ac; i++) ac = in[i] != 0;
  if (!ac) {
    for (int c = 0; c < 8; c++) {
      const int16_t v = w16((int32_t)(uint16_t)w16(in[c] * q[c]) << 2);
      for (int r = 0; r < 8; r++) ws[8 * r + c] = v;
    }
  } else {
    for (int i = 0; i < 64; i++) dq[i] = w16(in[i] * q[i]);
    idct_pass(dq, 11, o);  // columns
    for (int i = 0; i < 64; i++) ws[i] = sat16(o[i]);
  }
  for (int r = 0; r < 8; r++)  // rows, as lanes
    for (int i = 0; i < 8; i++) wt[8 * i + r] = ws[8 * r + i];
  idct_pass(wt, 18, o);
  for (int r = 0; r < 8; r++) {
    uint8_t* op = out + (size_t)r * stride;
    for (int x = 0; x < 8; x++) op[x] = (uint8_t)(std::min(std::max(o[8 * x + r], -128), 127) + 128);
  }
}

struct Decoder {
  Src s;
  uint16_t qt[4][64] = {};
  bool qdef[4] = {};
  HuffSpec dcs[4], acs[4];
  bool sof = false;
  int width = 0, height = 0, nc = 0;
  Comp comp[3];
  int maxh = 1, maxv = 1, mcux = 0, mcuy = 0;
  int restart = 0;
  bool jfif = false, adobe = false;
  int transform = 0;
  int unread = 0;
  int orientation = 1;
  bool app1_seen = false;
  // the current scan
  int ns = 0, sc[4] = {};

  Decoder(const uint8_t* data, size_t n) : s{data, data + n} {}

  void first_marker() {
    const int c = s.byte(), c2 = s.byte();
    if (c != 0xFF || c2 != 0xD8) fail(kCorrupt);
  }

  void get_sof(int m) {
    if (sof) fail(kCorrupt);
    int len = s.u16();
    const int prec = s.byte();
    height = s.u16();
    width = s.u16();
    nc = s.byte();
    len -= 8;
    // the coding mode first: a mode this codec leaves out is named as such
    if (m == 0xC2) fail(kProgressive);
    if (m == 0xC3) fail(kLossless);
    if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xCD || m == 0xCE || m == 0xCF)
      fail(kHierarchical);
    if (m == 0xC9 || m == 0xCA || m == 0xCB) fail(kArithmetic);
    if (height <= 0 || width <= 0 || nc <= 0) fail(kCorrupt);
    if (len != nc * 3) fail(kCorrupt);
    if (prec == 12) fail(kPrecision);
    if (prec != 8) fail(kCorrupt);
    if (nc != 1 && nc != 3) fail(kComponents);
    if (width > 65500 || height > 65500) fail(kCorrupt);
    for (int i = 0; i < nc; i++) {
      Comp& c = comp[i];
      c.id = s.byte();
      const int hv = s.byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = s.byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail(kCorrupt);
    }
    sof = true;
    maxh = maxv = 1;
    for (int i = 0; i < nc; i++) {
      maxh = std::max(maxh, comp[i].h);
      maxv = std::max(maxv, comp[i].v);
    }
    mcux = (width + 8 * maxh - 1) / (8 * maxh);
    mcuy = (height + 8 * maxv - 1) / (8 * maxv);
    for (int i = 0; i < nc; i++) {
      Comp& c = comp[i];
      c.wib = (int)(((int64_t)width * c.h + 8 * maxh - 1) / (8 * maxh));
      c.hib = (int)(((int64_t)height * c.v + 8 * maxv - 1) / (8 * maxv));
      c.dw = (int)(((int64_t)width * c.h + maxh - 1) / maxh);
      c.dh = (int)(((int64_t)height * c.v + maxv - 1) / maxv);
      c.bw = std::max(mcux * c.h, c.wib);
      c.bh = std::max(mcuy * c.v, c.hib);
    }
  }

  void get_dht() {
    long len = s.u16() - 2;
    while (len > 16) {
      int index = s.byte();
      HuffSpec spec;
      int count = 0;
      for (int l = 1; l <= 16; l++) {
        spec.bits[l] = (uint8_t)s.byte();
        count += spec.bits[l];
      }
      len -= 17;
      if (count > 256 || count > len) fail(kCorrupt);
      for (int i = 0; i < count; i++) spec.val[i] = (uint8_t)s.byte();
      len -= count;
      const bool ac = index & 0x10;
      index &= ~0x10;
      if (index < 0 || index >= 4) fail(kCorrupt);
      spec.defined = true;
      (ac ? acs : dcs)[index] = spec;
    }
    if (len != 0) fail(kCorrupt);
  }

  void get_dqt() {
    long len = s.u16() - 2;
    while (len > 0) {
      len--;
      int n = s.byte();
      const int prec = n >> 4;
      n &= 0x0F;
      if (n >= 4) fail(kCorrupt);
      int count = 64;
      if (len < 64L * (prec + 1)) {
        for (int i = 0; i < 64; i++) qt[n][i] = 1;
        count = (int)(len >> prec);
      }
      for (int i = 0; i < count; i++) {
        const int v = prec ? s.u16() : s.byte();
        qt[n][kNatural[i]] = (uint16_t)v;
      }
      len -= 64L * (prec + 1);  // a short last table leaves len < 0: an error
      qdef[n] = true;
    }
    if (len != 0) fail(kCorrupt);
  }

  void get_dri() {
    if (s.u16() != 4) fail(kCorrupt);
    restart = s.u16();
  }

  // jdmarker.c get_interesting_appn for APP0 (JFIF) and APP14 (Adobe);
  // the first APP1 is kept for its EXIF orientation, as OpenCV reads it
  void get_app(int m) {
    long len = s.u16() - 2;
    if (m == 0xE1 && !app1_seen) {
      app1_seen = true;
      if (len > 0 && len <= s.end - s.p) orientation = exif_orientation(s.p, (size_t)len);
    }
    if (m != 0xE0 && m != 0xEE) {
      s.skip(len);
      return;
    }
    uint8_t b[14];
    const long take = len >= 14 ? 14 : (len > 0 ? len : 0);
    for (long i = 0; i < take; i++) b[i] = (uint8_t)s.byte();
    len -= take;
    if (m == 0xE0 && take >= 14 && !std::memcmp(b, "JFIF\0", 5)) jfif = true;
    if (m == 0xEE && take >= 12 && !std::memcmp(b, "Adobe", 5)) {
      adobe = true;
      transform = b[11];
    }
    s.skip(len);
  }

  // OpenCV's ExifReader on an APP1's data: a TIFF header 6 bytes in, IFD0,
  // tag 0x0112's first two value bytes; 1 (as stored) when absent
  static int exif_orientation(const uint8_t* d, size_t n) {
    if (n <= 6) return 1;
    d += 6;
    n -= 6;
    if (n < 8) return 1;
    bool le;
    if (d[0] == 'I' && d[1] == 'I') le = true;
    else if (d[0] == 'M' && d[1] == 'M') le = false;
    else return 1;
    auto u16 = [&](size_t o) -> long {
      if (o + 2 > n) return -1;
      return le ? (d[o] | (d[o + 1] << 8)) : ((d[o] << 8) | d[o + 1]);
    };
    auto u32 = [&](size_t o) -> long long {
      if (o + 4 > n) return -1;
      return le ? ((long long)d[o] | (d[o + 1] << 8) | (d[o + 2] << 16) | ((long long)d[o + 3] << 24))
                : (((long long)d[o] << 24) | (d[o + 1] << 16) | (d[o + 2] << 8) | d[o + 3]);
    };
    if (u16(2) != 0x2A) return 1;
    const long long off = u32(4);
    if (off < 0) return 1;
    const long entries = u16((size_t)off);
    if (entries < 0) return 1;
    int orient = 1;
    for (long i = 0; i < entries; i++) {
      const size_t e = (size_t)off + 2 + 12 * (size_t)i;
      const long tag = u16(e);
      if (tag < 0 || e + 12 > n) return 1;  // OpenCV drops the whole EXIF then
      if (tag == 0x0112) orient = (int)u16(e + 8);
    }
    return orient;
  }

  // jdmarker.c read_markers: up to SOS (returns 0xDA, its header not read)
  // or EOI (0xD9)
  int read_markers() {
    for (;;) {
      const int m = unread ? unread : s.next_marker();
      unread = 0;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7:
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          get_sof(m);
          break;
        case 0xDA:
        case 0xD9:
          return m;
        case 0xC4: get_dht(); break;
        case 0xDB: get_dqt(); break;
        case 0xDD: get_dri(); break;
        case 0xCC:  // DAC
        case 0xDC:  // DNL
        case 0xFE:  // COM
          s.skip(s.u16() - 2);
          break;
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6: case 0xD7:
        case 0x01:  // TEM
          break;
        default:
          if (m >= 0xE0 && m <= 0xEF) {
            get_app(m);
            break;
          }
          fail(kCorrupt);  // SOI again, JPG, or a reserved code
      }
    }
  }

  // the markers up to the first SOS and that SOS, as jpeg_read_header
  // reads them; then OpenCV's size check
  void header() {
    first_marker();
    if (read_markers() != 0xDA || !sof) fail(kCorrupt);
    get_sos();
    if ((int64_t)width * height > kMaxPixels) fail(kTooLarge);
  }

  void get_sos() {
    const int len = s.u16();
    ns = s.byte();
    if (len != ns * 2 + 6 || ns < 1 || ns > 4) fail(kCorrupt);
    bool used[3] = {};
    for (int i = 0; i < ns; i++) {
      const int cc = s.byte(), t = s.byte();
      int k = 0;
      while (k < nc && !(comp[k].id == cc && !used[k])) k++;
      if (k == nc) fail(kCorrupt);
      used[k] = true;
      sc[i] = k;
      comp[k].dc = t >> 4;
      comp[k].ac = t & 15;
    }
    s.byte();  // Ss, Se, Ah/Al: libjpeg warns and decodes as sequential
    s.byte();
    s.byte();
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; i++) blocks += comp[sc[i]].h * comp[sc[i]].v;
      if (blocks > 10) fail(kCorrupt);
    }
  }

  void resync(Bits& br, int desired) {  // jdmarker.c jpeg_resync_to_restart
    int m = br.marker;
    for (;;) {
      int action;
      if (m < 0xC0) action = 2;
      else if (m < 0xD0 || m > 0xD7) action = 3;
      else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) action = 3;
      else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) action = 2;
      else action = 1;
      if (action == 1) {
        br.marker = 0;
        return;
      }
      if (action == 3) {
        br.marker = m;
        return;
      }
      m = s.next_marker();
    }
  }

  // jdhuff.c: a table no DHT defined is the standard one (tables 0 and 1)
  static const HuffSpec& table(HuffSpec* specs, int index, bool dc) {
    if (index > 3) fail(kCorrupt);
    HuffSpec& h = specs[index];
    if (!h.defined) {
      if (index > 1) fail(kCorrupt);
      const uint8_t* bits = dc ? (index ? kDcChromaBits : kDcLumaBits)
                               : (index ? kAcChromaBits : kAcLumaBits);
      const uint8_t* vals = dc ? kDcVals : (index ? kAcChromaVals : kAcLumaVals);
      int count = 0;
      for (int l = 1; l <= 16; l++) count += (h.bits[l] = bits[l]);
      std::memcpy(h.val, vals, (size_t)count);
      h.defined = true;
    }
    return h;
  }

  void scan() {
    HuffDec dtab[4], atab[4];
    for (int i = 0; i < ns; i++) {
      Comp& c = comp[sc[i]];
      derive(table(dcs, c.dc, true), true, dtab[i]);
      derive(table(acs, c.ac, false), false, atab[i]);
      if (!c.latched) {  // jdinput.c latch_quant_tables
        if (c.tq > 3 || !qdef[c.tq]) fail(kCorrupt);
        for (int k = 0; k < 64; k++) c.q[k] = (int16_t)qt[c.tq][k];
        c.latched = true;
      }
      if (c.coef.empty()) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    const bool inter = ns > 1;
    const int mx_n = inter ? mcux : comp[sc[0]].wib;
    const int my_n = inter ? mcuy : comp[sc[0]].hib;
    Bits br{&s};
    int last_dc[4] = {};
    int togo = restart, next_rst = 0;
    for (int my = 0; my < my_n; my++) {
      for (int mx = 0; mx < mx_n; mx++) {
        if (restart && togo == 0) {  // jdhuff.c process_restart
          br.drop();
          if (!br.marker) br.marker = s.next_marker();
          if (br.marker == 0xD0 + next_rst) br.marker = 0;
          else resync(br, next_rst);
          next_rst = (next_rst + 1) & 7;
          for (int& d : last_dc) d = 0;
          togo = restart;
          if (!br.marker) br.insufficient = false;
        }
        if (!br.insufficient) {
          for (int i = 0; i < ns; i++) {
            Comp& c = comp[sc[i]];
            const int h = inter ? c.h : 1, v = inter ? c.v : 1;
            for (int by = 0; by < v; by++) {
              for (int bx = 0; bx < h; bx++) {
                int16_t* blk = c.coef.data() +
                               ((size_t)(my * v + by) * c.bw + (size_t)(mx * h + bx)) * 64;
                int t = br.decode(dtab[i]);
                const int diff = t ? br.extend(t) : 0;
                last_dc[i] = (int)((uint32_t)last_dc[i] + (uint32_t)diff);
                blk[0] = (int16_t)last_dc[i];
                const HuffDec& ac = atab[i];
                for (int k = 1; k < 64; k++) {
                  if (br.cnt < 32) br.fill();
                  const int32_t fa = ac.fast_ac[br.buf >> (64 - kLook)];
                  if (fa) {
                    k += (fa >> 4) & 15;
                    br.skip(fa & 15);
                    blk[kNatural[k]] = (int16_t)(fa >> 8);
                    continue;
                  }
                  t = br.decode(ac);
                  const int r = t >> 4, n = t & 15;
                  if (n) {
                    k += r;
                    blk[kNatural[k]] = (int16_t)br.extend(n);
                  } else {
                    if (r != 15) break;
                    k += 15;
                  }
                }
              }
            }
          }
        }
        if (restart) togo--;
      }
    }
    unread = br.marker;
  }

  void decode_all() {
    header();
    // a first scan of every component is the whole image: libjpeg decodes
    // it in one pass and hands out the rows without reading what follows
    // (OpenCV stops there); otherwise the scans are buffered up to EOI
    const bool one_pass = ns == nc;
    for (;;) {
      scan();
      if (one_pass) return;
      if (read_markers() != 0xDA) return;
      get_sos();
    }
  }

  // IDCT of every block a component's output reads
  void idct(Comp& c) {
    const int stride = c.wib * 8;
    c.plane.assign((size_t)stride * c.hib * 8, 128);
    if (!c.latched) return;  // never scanned: zero coefficients, mid-grey
    for (int by = 0; by < c.hib; by++)
      for (int bx = 0; bx < c.wib; bx++)
        idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, c.q,
                   c.plane.data() + (size_t)by * 8 * stride + bx * 8, stride);
  }

  // jdsample.c: output row y of component c at full size into out[0, width)
  void upsample_row(const Comp& c, int y, uint8_t* out, std::vector<int>& sums) const {
    const int he = maxh / c.h, ve = maxv / c.v, stride = c.wib * 8;
    const uint8_t* P = c.plane.data();
    auto row = [&](int i) { return P + (size_t)std::min(std::max(i, 0), c.dh - 1) * stride; };
    const int dw = c.dw;
    if (he == 2 && ve == 1 && dw > 2) {  // h2v1_fancy_upsample
      const uint8_t* in = row(y);
      out[0] = in[0];
      out[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      for (int j = 1; j < dw - 1; j++) {
        const int v = in[j] * 3;
        out[2 * j] = (uint8_t)((v + in[j - 1] + 1) >> 2);
        out[2 * j + 1] = (uint8_t)((v + in[j + 1] + 2) >> 2);
      }
      out[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      out[2 * dw - 1] = in[dw - 1];
    } else if (he == 1 && ve == 2) {  // h1v2_fancy_upsample
      const int i = y >> 1;
      const uint8_t* near = row(i);
      const uint8_t* far = row(y & 1 ? i + 1 : i - 1);
      const int bias = y & 1 ? 2 : 1;
      for (int x = 0; x < width; x++) out[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
    } else if (he == 2 && ve == 2 && dw > 2) {  // h2v2_fancy_upsample
      const int i = y >> 1;
      const uint8_t* near = row(i);
      const uint8_t* far = row(y & 1 ? i + 1 : i - 1);
      int* cs = sums.data();
      for (int j = 0; j < dw; j++) cs[j] = near[j] * 3 + far[j];
      out[0] = (uint8_t)((cs[0] * 4 + 8) >> 4);
      out[1] = (uint8_t)((cs[0] * 3 + cs[1] + 7) >> 4);
      for (int j = 1; j < dw - 1; j++) {
        out[2 * j] = (uint8_t)((cs[j] * 3 + cs[j - 1] + 8) >> 4);
        out[2 * j + 1] = (uint8_t)((cs[j] * 3 + cs[j + 1] + 7) >> 4);
      }
      out[2 * dw - 2] = (uint8_t)((cs[dw - 1] * 3 + cs[dw - 2] + 8) >> 4);
      out[2 * dw - 1] = (uint8_t)((cs[dw - 1] * 4 + 7) >> 4);
    } else {  // fullsize, h2v1/h2v2 at widths of 2 or less, int_upsample
      const uint8_t* in = P + (size_t)(y / ve) * stride;
      if (he == 1) std::memcpy(out, in, (size_t)width);
      else
        for (int x = 0; x < width; x++) out[x] = in[x / he];
    }
  }

  void output(uint8_t* out, bool bgr) {
    const Tables& t = tables();
    // colour space (jdapimin.c default_decompress_parms)
    bool ycc = false;
    if (nc == 3) {
      if (jfif) ycc = true;
      else if (adobe) ycc = transform != 0;
      else ycc = !(comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66);
    }
    const int used = (nc == 3 && (bgr || !ycc)) ? 3 : 1;  // grey from YCbCr is Y alone
    for (int i = 0; i < used; i++) {
      Comp& c = comp[i];
      if (maxh % c.h || maxv % c.v) fail(kCorrupt);  // fractional ratios: libjpeg stops
      idct(c);
    }
    std::vector<uint8_t> rows((size_t)3 * (width + 16));
    std::vector<int> sums((size_t)width + 16);
    uint8_t* r[3] = {rows.data(), rows.data() + width + 16, rows.data() + 2 * (width + 16)};
    for (int y = 0; y < height; y++) {
      for (int i = 0; i < used; i++) upsample_row(comp[i], y, r[i], sums);
      uint8_t* o = out + (size_t)y * width * (bgr ? 3 : 1);
      if (used == 1) {
        if (bgr)
          for (int x = 0; x < width; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = r[0][x];
        else
          std::memcpy(o, r[0], (size_t)width);
      } else if (!bgr) {  // rgb_gray_convert
        for (int x = 0; x < width; x++)
          o[x] = (uint8_t)((t.rgb_ycc[r[0][x]] + t.rgb_ycc[256 + r[1][x]] +
                            t.rgb_ycc[512 + r[2][x]]) >> 16);
      } else if (ycc) {  // ycc_rgb_convert
        for (int x = 0; x < width; x++) {
          const int Y = r[0][x], cb = r[1][x], cr = r[2][x];
          o[3 * x + 2] = clamp255(Y + t.cr_r[cr]);
          o[3 * x + 1] = clamp255(Y + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16));
          o[3 * x + 0] = clamp255(Y + t.cb_b[cb]);
        }
      } else {  // RGB stored
        for (int x = 0; x < width; x++) {
          o[3 * x + 2] = r[0][x];
          o[3 * x + 1] = r[1][x];
          o[3 * x + 0] = r[2][x];
        }
      }
    }
  }
};

// ----------------------------------------------------------------- encode

const uint8_t kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

struct HuffEnc {
  uint16_t code[256] = {};
  uint8_t size[256] = {};
  HuffEnc(const uint8_t* bits, const uint8_t* vals) {  // jchuff.c jpeg_make_c_derived_tbl
    uint32_t c = 0;
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l]; i++, p++) {
        code[vals[p]] = (uint16_t)c++;
        size[vals[p]] = (uint8_t)l;
      }
      c <<= 1;
    }
  }
};

struct Quant {  // jcdctmgr.c compute_reciprocal, of quantval << 3 (islow)
  uint32_t recip[64], corr[64];
  int shift[64];
  uint8_t q[64];
  void set(const uint8_t* q8) {
    for (int i = 0; i < 64; i++) {
      q[i] = q8[i];
      const uint32_t d = (uint32_t)q8[i] << 3;
      int b = 31 - __builtin_clz(d);
      int r = 16 + b;
      uint32_t fq = (uint32_t)((1ull << r) / d), fr = (uint32_t)((1ull << r) % d);
      uint32_t c = d / 2;
      if (fr == 0) {
        fq >>= 1;
        r--;
      } else if (fr <= d / 2) {
        c++;
      } else {
        fq++;
      }
      recip[i] = fq & 0xFFFF;
      corr[i] = c & 0xFFFF;
      shift[i] = r;
    }
  }
  int16_t apply(int i, int v) const {
    if (v < 0) return (int16_t)-(int)((((uint32_t)(-v) + corr[i]) * recip[i]) >> shift[i]);
    return (int16_t)((((uint32_t)v + corr[i]) * recip[i]) >> shift[i]);
  }
};

// jfdctint.c jpeg_fdct_islow on samples already less 128, in place
void fdct_islow(int32_t* d) {
  constexpr int CB = 13, P1 = 2;
  for (int r = 0; r < 8; r++) {
    int32_t* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    p[0] = (int16_t)((t10 + t11) * (1 << P1));
    p[4] = (int16_t)((t10 - t11) * (1 << P1));
    int64_t z1 = (t12 + t13) * 4433;
    p[2] = (int16_t)descale(z1 + t13 * 6270, CB - P1);
    p[6] = (int16_t)descale(z1 + t12 * -15137, CB - P1);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const int64_t z5 = (z3 + z4) * 9633;
    tmp4 *= 2446;
    tmp5 *= 16819;
    tmp6 *= 25172;
    tmp7 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 = z3 * -16069 + z5;
    z4 = z4 * -3196 + z5;
    p[7] = (int16_t)descale(tmp4 + z1 + z3, CB - P1);
    p[5] = (int16_t)descale(tmp5 + z2 + z4, CB - P1);
    p[3] = (int16_t)descale(tmp6 + z2 + z3, CB - P1);
    p[1] = (int16_t)descale(tmp7 + z1 + z4, CB - P1);
  }
  for (int c = 0; c < 8; c++) {
    int32_t* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    p[0] = (int16_t)descale(t10 + t11, P1);
    p[32] = (int16_t)descale(t10 - t11, P1);
    int64_t z1 = (t12 + t13) * 4433;
    p[16] = (int16_t)descale(z1 + t13 * 6270, CB + P1);
    p[48] = (int16_t)descale(z1 + t12 * -15137, CB + P1);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const int64_t z5 = (z3 + z4) * 9633;
    tmp4 *= 2446;
    tmp5 *= 16819;
    tmp6 *= 25172;
    tmp7 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 = z3 * -16069 + z5;
    z4 = z4 * -3196 + z5;
    p[56] = (int16_t)descale(tmp4 + z1 + z3, CB + P1);
    p[40] = (int16_t)descale(tmp5 + z2 + z4, CB + P1);
    p[24] = (int16_t)descale(tmp6 + z2 + z3, CB + P1);
    p[8] = (int16_t)descale(tmp7 + z1 + z4, CB + P1);
  }
}

struct Writer {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int nbits = 0;

  void byte(int b) { out.push_back((uint8_t)b); }
  void u16(int v) {
    byte(v >> 8);
    byte(v & 0xFF);
  }
  void bits(uint32_t code, int size) {
    if (!size) return;
    acc = (acc << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      const uint8_t c = (uint8_t)(acc >> (nbits - 8));
      out.push_back(c);
      if (c == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {  // fill the partial byte with ones
    if (nbits) bits(0x7F, 8 - nbits);
    acc = 0;
    nbits = 0;
  }
  void dht(int index, const uint8_t* b, const uint8_t* vals) {
    int count = 0;
    for (int l = 1; l <= 16; l++) count += b[l];
    byte(0xFF);
    byte(0xC4);
    u16(2 + 1 + 16 + count);
    byte(index);
    for (int l = 1; l <= 16; l++) byte(b[l]);
    for (int i = 0; i < count; i++) byte(vals[i]);
  }
};

void encode_block(Writer& w, const int16_t* blk, int& last_dc, const HuffEnc& dc, const HuffEnc& ac) {
  int temp = blk[0] - last_dc;
  last_dc = blk[0];
  int temp2 = temp;
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int n = temp ? 32 - __builtin_clz((unsigned)temp) : 0;
  w.bits(dc.code[n], dc.size[n]);
  w.bits((uint32_t)temp2, n);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    temp = blk[kNatural[k]];
    if (!temp) {
      run++;
      continue;
    }
    while (run > 15) {
      w.bits(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    n = 32 - __builtin_clz((unsigned)temp);
    const int sym = (run << 4) + n;
    w.bits(ac.code[sym], ac.size[sym]);
    w.bits((uint32_t)temp2, n);
    run = 0;
  }
  if (run > 0) w.bits(ac.code[0], ac.size[0]);
}

// A plane the encoder reads one block at a time: samples of (pw, ph) with
// its rows and columns beyond replicated from the last (jcprepct.c and
// jcsample.c expand_bottom_edge / expand_right_edge)
struct Plane {
  std::vector<uint8_t> px;
  int w = 0, h = 0;
  void block(int bx, int by, int32_t* out) const {
    for (int r = 0; r < 8; r++) {
      const uint8_t* row = px.data() + (size_t)std::min(by * 8 + r, h - 1) * w;
      for (int c = 0; c < 8; c++) out[8 * r + c] = (int)row[std::min(bx * 8 + c, w - 1)] - 128;
    }
  }
};

std::vector<uint8_t> encode(const uint8_t* img, int W, int H, int nc, int quality) {
  const Tables& t = tables();
  // jcparam.c jpeg_quality_scaling and jpeg_add_quant_table (baseline)
  quality = std::min(std::max(quality, 1), 100);
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint8_t q8[2][64];
  for (int k = 0; k < 2; k++)
    for (int i = 0; i < 64; i++) {
      long v = ((long)(k ? kStdChroma : kStdLuma)[i] * scale + 50) / 100;
      q8[k][i] = (uint8_t)std::min(std::max(v, 1L), 255L);
    }
  Quant quant[2];
  quant[0].set(q8[0]);
  quant[1].set(q8[1]);

  // components: Y 2x2 and Cb, Cr 1x1 (4:2:0), or Y alone
  Plane planes[3];
  if (nc == 1) {
    planes[0].px.assign(img, img + (size_t)W * H);
    planes[0].w = W;
    planes[0].h = H;
  } else {
    std::vector<uint8_t> Y((size_t)W * H), Cb((size_t)W * H), Cr((size_t)W * H);
    for (size_t i = 0; i < (size_t)W * H; i++) {  // BGR in, as cv2.imwrite takes it
      const int b = img[3 * i], g = img[3 * i + 1], r = img[3 * i + 2];
      Y[i] = (uint8_t)((t.rgb_ycc[r] + t.rgb_ycc[256 + g] + t.rgb_ycc[512 + b]) >> 16);
      Cb[i] = (uint8_t)((t.rgb_ycc[768 + r] + t.rgb_ycc[1024 + g] + t.rgb_ycc[1280 + b]) >> 16);
      Cr[i] = (uint8_t)((t.rgb_ycc[1280 + r] + t.rgb_ycc[1536 + g] + t.rgb_ycc[1792 + b]) >> 16);
    }
    planes[0].px = std::move(Y);
    planes[0].w = W;
    planes[0].h = H;
    // jcsample.c h2v2_downsample: the 2x2 mean with biases 1, 2, 1, 2, ...
    // along a row, over the full-size columns replicated out to the
    // blocks' width; the rows past the last one replicate it
    const int cw = (W + 15) / 16 * 8, ch = (H + 1) / 2;
    const std::vector<uint8_t>* full[2] = {&Cb, &Cr};
    for (int k = 0; k < 2; k++) {
      Plane& p = planes[1 + k];
      p.w = cw;
      p.h = ch;
      p.px.resize((size_t)cw * ch);
      const uint8_t* f = full[k]->data();
      for (int y = 0; y < ch; y++) {
        const uint8_t* r0 = f + (size_t)std::min(2 * y, H - 1) * W;
        const uint8_t* r1 = f + (size_t)std::min(2 * y + 1, H - 1) * W;
        for (int x = 0; x < cw; x++) {
          const int x0 = std::min(2 * x, W - 1), x1 = std::min(2 * x + 1, W - 1);
          p.px[(size_t)y * cw + x] = (uint8_t)((r0[x0] + r0[x1] + r1[x0] + r1[x1] + 1 + (x & 1)) >> 2);
        }
      }
    }
  }
  const int mh = nc == 3 ? 2 : 1;
  const int mcux = (W + 8 * mh - 1) / (8 * mh), mcuy = (H + 8 * mh - 1) / (8 * mh);
  struct C {
    int h, v, wib, hib, tbl;
  } comps[3];
  for (int i = 0; i < nc; i++) {
    const int h = i == 0 ? mh : 1;
    comps[i] = {h, h, (W * h + 8 * mh - 1) / (8 * mh), (H * h + 8 * mh - 1) / (8 * mh), i ? 1 : 0};
  }

  Writer w;
  w.out.reserve((size_t)W * H * nc / 2 + 1024);
  w.byte(0xFF);
  w.byte(0xD8);
  static const uint8_t jfif[18] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  w.out.insert(w.out.end(), jfif, jfif + 18);
  for (int k = 0; k < (nc == 3 ? 2 : 1); k++) {
    w.byte(0xFF);
    w.byte(0xDB);
    w.u16(67);
    w.byte(k);
    for (int i = 0; i < 64; i++) w.byte(q8[k][kNatural[i]]);
  }
  w.byte(0xFF);
  w.byte(0xC0);
  w.u16(8 + 3 * nc);
  w.byte(8);
  w.u16(H);
  w.u16(W);
  w.byte(nc);
  for (int i = 0; i < nc; i++) {
    w.byte(i + 1);
    w.byte((comps[i].h << 4) | comps[i].v);
    w.byte(comps[i].tbl);
  }
  w.dht(0x00, kDcLumaBits, kDcVals);
  w.dht(0x10, kAcLumaBits, kAcLumaVals);
  if (nc == 3) {
    w.dht(0x01, kDcChromaBits, kDcVals);
    w.dht(0x11, kAcChromaBits, kAcChromaVals);
  }
  w.byte(0xFF);
  w.byte(0xDA);
  w.u16(6 + 2 * nc);
  w.byte(nc);
  for (int i = 0; i < nc; i++) {
    w.byte(i + 1);
    w.byte(i ? 0x11 : 0x00);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);

  const HuffEnc dc[2] = {HuffEnc(kDcLumaBits, kDcVals), HuffEnc(kDcChromaBits, kDcVals)};
  const HuffEnc ac[2] = {HuffEnc(kAcLumaBits, kAcLumaVals), HuffEnc(kAcChromaBits, kAcChromaVals)};
  int last_dc[3] = {};
  int32_t ws[64];
  int16_t mcu[6][64];
  // a one-component scan is not interleaved: an MCU is one block
  const int mx_n = nc == 3 ? mcux : comps[0].wib, my_n = nc == 3 ? mcuy : comps[0].hib;
  for (int my = 0; my < my_n; my++) {
    for (int mx = 0; mx < mx_n; mx++) {
      int blkn = 0;
      for (int i = 0; i < nc; i++) {  // jccoefct.c compress_data
        const C& c = comps[i];
        const int MW = nc == 3 ? c.h : 1, MH = nc == 3 ? c.v : 1;
        const int last_col = c.wib % MW ? c.wib % MW : MW, last_row = c.hib % MH ? c.hib % MH : MH;
        const int blockcnt = mx < mx_n - 1 ? MW : last_col;
        for (int yi = 0; yi < MH; yi++) {
          if (my < my_n - 1 || yi < last_row) {
            for (int bi = 0; bi < blockcnt; bi++) {
              planes[i].block(mx * MW + bi, my * MH + yi, ws);
              fdct_islow(ws);
              for (int k = 0; k < 64; k++) mcu[blkn + bi][k] = quant[c.tbl].apply(k, ws[k]);
            }
            for (int bi = blockcnt; bi < MW; bi++) {  // dummy blocks at the right edge
              std::memset(mcu[blkn + bi], 0, sizeof mcu[0]);
              mcu[blkn + bi][0] = mcu[blkn + bi - 1][0];
            }
          } else {  // a row of dummy blocks at the bottom
            for (int bi = 0; bi < MW; bi++) {
              std::memset(mcu[blkn + bi], 0, sizeof mcu[0]);
              mcu[blkn + bi][0] = mcu[blkn - 1][0];
            }
          }
          blkn += MW;
        }
      }
      blkn = 0;
      for (int i = 0; i < nc; i++) {
        const C& c = comps[i];
        const int n = nc == 3 ? c.h * c.v : 1;
        for (int b = 0; b < n; b++, blkn++) encode_block(w, mcu[blkn], last_dc[i], dc[c.tbl], ac[c.tbl]);
      }
    }
  }
  w.flush();
  w.byte(0xFF);
  w.byte(0xD9);
  return std::move(w.out);
}

}  // namespace

extern "C" {

// Width, height and component count (1 or 3) of the JPEG in data[0, n),
// from its markers up to the first SOS. -> a Code.
int sp3d_jpeg_header(const uint8_t* data, size_t n, int* w, int* h, int* components) {
  try {
    Decoder d(data, n);
    d.header();
    *w = d.width;
    *h = d.height;
    *components = d.nc;
    return kOk;
  } catch (const Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return kBadArgs;
  }
}

// The EXIF orientation (1-8, 1 when there is none) of the first APP1
// before the first SOS; 0 if the header does not parse.
int sp3d_jpeg_orientation(const uint8_t* data, size_t n) {
  try {
    Decoder d(data, n);
    d.header();
    return d.orientation;
  } catch (...) {
    return 0;
  }
}

// Decode into out: (h, w, 3) BGR when bgr, else (h, w) grey (libjpeg's
// JCS_GRAYSCALE output: Y alone, or the weighted sum of stored RGB);
// w and h as sp3d_jpeg_header gave them. -> a Code.
int sp3d_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, int w, int h, int bgr) {
  try {
    Decoder d(data, n);
    d.decode_all();
    if (d.width != w || d.height != h) return kBadArgs;
    d.output(out, bgr != 0);
    return kOk;
  } catch (const Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return kBadArgs;
  }
}

// Encode (h, w, components) uint8 (components 3: BGR, 4:2:0; 1: grey) at
// quality 1-100 into out[0, cap). -> the byte count, or -(needed bytes)
// when cap is too small, or 0 for arguments out of range.
long long sp3d_jpeg_encode(const uint8_t* img, int w, int h, int components, int quality,
                           uint8_t* out, size_t cap) {
  if (w <= 0 || h <= 0 || w > 65500 || h > 65500 || (components != 1 && components != 3)) return 0;
  try {
    const std::vector<uint8_t> bytes = encode(img, w, h, components, quality);
    if (bytes.size() > cap) return -(long long)bytes.size();
    std::memcpy(out, bytes.data(), bytes.size());
    return (long long)bytes.size();
  } catch (...) {
    return 0;
  }
}

// PNG row unfiltering (the five filter types of the PNG spec, section 9):
// raw holds h rows of 1 + stride bytes (the filter type, then the filtered
// row), bpp bytes a pixel; out gets h rows of stride bytes. -> a Code
// (kCorrupt for an unknown filter type).
int sp3d_png_unfilter(const uint8_t* raw, int h, int stride, int bpp, uint8_t* out) {
  if (h < 0 || stride < 0 || bpp < 1) return kBadArgs;
  std::vector<uint8_t> zero((size_t)stride, 0);
  for (int y = 0; y < h; y++) {
    const uint8_t* line = raw + (size_t)y * (stride + 1);
    const uint8_t kind = line[0];
    line++;
    uint8_t* o = out + (size_t)y * stride;
    const uint8_t* prev = y ? o - stride : zero.data();
    switch (kind) {
      case 0:
        std::memcpy(o, line, (size_t)stride);
        break;
      case 1:
        for (int i = 0; i < stride; i++) o[i] = (uint8_t)(line[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < stride; i++) o[i] = (uint8_t)(line[i] + prev[i]);
        break;
      case 3:
        for (int i = 0; i < stride; i++) {
          const int a = i >= bpp ? o[i - bpp] : 0;
          o[i] = (uint8_t)(line[i] + ((a + prev[i]) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < stride; i++) {
          const int a = i >= bpp ? o[i - bpp] : 0, b = prev[i], c = i >= bpp ? prev[i - bpp] : 0;
          const int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[i] = (uint8_t)(line[i] + pred);
        }
        break;
      default:
        return kCorrupt;
    }
  }
  return kOk;
}

}  // extern "C"
