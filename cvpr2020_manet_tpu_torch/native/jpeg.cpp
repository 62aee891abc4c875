// Baseline JPEG decoder, bit-exact with libjpeg(-turbo)'s default output.
//
// DAVIS frames are baseline JFIF JPEGs. This decoder reproduces what
// libjpeg gives a caller that keeps its defaults (out_color_space JCS_RGB,
// dct_method JDCT_ISLOW, do_fancy_upsampling TRUE), which is what PIL
// returns:
//   - Huffman-coded sequential DCT (SOF0, SOF1), 8-bit samples, one
//     interleaved scan, restart intervals;
//   - libjpeg's ISLOW integer IDCT (jidctint.c) and its post-IDCT range
//     limit table;
//   - libjpeg's "fancy" triangle upsampling for h2v1 and h2v2 chroma
//     (jdsample.c), with the edge rows and columns replicated as its main
//     controller does, and box upsampling where a chroma row is at most
//     2 samples wide;
//   - libjpeg's fixed-point YCbCr -> RGB tables (jdcolor.c).
// Progressive, lossless and arithmetic-coded files, 12-bit samples,
// grayscale, CMYK, RGB-coded (Adobe transform 0) files, other chroma
// layouts and non-interleaved or multiple scans raise with a message.
//
// C interface (ctypes): ivos_jpeg_size, then ivos_jpeg_decode into a
// caller-owned (H, W, 3) uint8 buffer; each returns 0 or writes an error.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// zigzag -> natural order, with libjpeg's 16 safety entries for corrupt
// run lengths that step past 63
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError(msg); }

constexpr int kLookBits = 9;

struct Huffman {
  bool present = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
  // code length and value of the code that starts each kLookBits-bit
  // prefix (length 0: the code is longer)
  uint8_t look_len[1 << kLookBits];
  uint8_t look_val[1 << kLookBits];

  void build(const uint8_t bits[17], const uint8_t* vals, int count) {
    // jdhuff.c jpeg_make_d_derived_tbl: canonical code assignment
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) {
        huffcode[p++] = code;
        code++;
      }
      if (code >= (1 << si)) fail("bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0xFFFFF;
    std::memcpy(huffval, vals, count);
    std::memset(look_len, 0, sizeof(look_len));
    p = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 0; i < bits[l]; i++, p++) {
        int prefix = huffcode[p] << (kLookBits - l);
        for (int j = 0; j < (1 << (kLookBits - l)); j++) {
          look_len[prefix + j] = (uint8_t)l;
          look_val[prefix + j] = huffval[p];
        }
      }
    }
    present = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;               // this scan's DC / AC table
  int width = 0, height = 0;        // samples (downsampled_width/height)
  int bw = 0, bh = 0;               // blocks of the coefficient grid
  int dc_pred = 0;
  int32_t quant[64];                // natural order
  std::vector<int16_t> coef;        // bh x bw blocks of 64, natural order
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : p_(data), n_(n) {}

  void read_header() {
    if (n_ < 2 || p_[0] != 0xFF || p_[1] != 0xD8) fail("not a JPEG file (no SOI)");
    pos_ = 2;
    while (!have_frame_) handle_marker(next_marker());
  }

  int width() const { return width_; }
  int height() const { return height_; }

  void decode(uint8_t* out) {
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;                    // EOI
      handle_marker(m);
    }
    if (!scanned_) fail("JPEG has no image data (no SOS before EOI)");
    std::vector<std::vector<uint8_t>> planes(3);
    for (int c = 0; c < 3; c++) idct_component(comps_[c], planes[c]);
    std::vector<uint8_t> full[3];
    for (int c = 0; c < 3; c++) upsample(comps_[c], planes[c], full[c]);
    color_convert(full, out);
  }

 private:
  const uint8_t* p_;
  size_t n_;
  size_t pos_ = 0;
  int32_t qt_[4][64];
  bool qt_present_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  int restart_interval_ = 0;
  bool have_frame_ = false, scanned_ = false;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;
  int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1;
  int mcus_x_ = 0, mcus_y_ = 0;
  Component comps_[3];

  // ---------------------------------------------------------- markers
  uint8_t byte() {
    if (pos_ >= n_) fail("JPEG file is truncated");
    return p_[pos_++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  int next_marker() {
    // skip garbage up to 0xFF, then fill bytes
    uint8_t c = byte();
    while (c != 0xFF) c = byte();
    do c = byte(); while (c == 0xFF);
    if (c == 0) fail("corrupt JPEG: stuffed zero outside entropy data");
    return c;
  }
  size_t segment(int* len) {
    *len = u16() - 2;
    if (*len < 0 || pos_ + (size_t)*len > n_) fail("JPEG file is truncated");
    size_t start = pos_;
    pos_ += *len;
    return start;
  }

  void handle_marker(int m) {
    int len;
    if (m == 0xC0 || m == 0xC1) {
      size_t s = segment(&len);
      read_sof(s, len);
    } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
               m != 0xCC) {
      const char* kind = (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE)
                             ? "progressive"
                         : (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF)
                             ? "lossless"
                             : "arithmetic-coded";
      fail(std::string(kind) + " JPEG is not supported (baseline and "
           "extended sequential Huffman only)");
    } else if (m == 0xCC) {
      fail("arithmetic-coded JPEG is not supported");
    } else if (m == 0xC4) {
      size_t s = segment(&len);
      read_dht(s, len);
    } else if (m == 0xDB) {
      size_t s = segment(&len);
      read_dqt(s, len);
    } else if (m == 0xDD) {
      size_t s = segment(&len);
      if (len != 2) fail("bad DRI segment");
      restart_interval_ = (p_[s] << 8) | p_[s + 1];
    } else if (m == 0xDA) {
      size_t s = segment(&len);
      read_sos(s, len);
    } else if (m == 0xE0) {
      size_t s = segment(&len);
      if (len >= 5 && std::memcmp(p_ + s, "JFIF\0", 5) == 0) saw_jfif_ = true;
    } else if (m == 0xEE) {
      size_t s = segment(&len);
      if (len >= 12 && std::memcmp(p_ + s, "Adobe", 5) == 0) {
        saw_adobe_ = true;
        adobe_transform_ = p_[s + 11];
      }
    } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE) {
      segment(&len);                            // other APPn, COM
    } else if (m == 0xD8) {
      fail("corrupt JPEG: second SOI");
    } else if (m == 0xD9) {
      fail("JPEG ends before its image data");
    } else if (m == 0xDC) {
      fail("JPEG with a DNL marker is not supported");
    } else if (m >= 0xD0 && m <= 0xD7) {
      // stray restart marker between segments: nothing to do
    } else {
      segment(&len);
    }
  }

  void read_sof(size_t s, int len) {
    if (have_frame_) fail("corrupt JPEG: second SOF");
    if (len < 6) fail("bad SOF segment");
    int precision = p_[s];
    height_ = (p_[s + 1] << 8) | p_[s + 2];
    width_ = (p_[s + 3] << 8) | p_[s + 4];
    int nc = p_[s + 5];
    if (precision != 8)
      fail("JPEG with " + std::to_string(precision) +
           "-bit samples is not supported (8-bit only)");
    if (height_ == 0) fail("JPEG with a DNL-defined height is not supported");
    if (width_ == 0) fail("bad JPEG width 0");
    if (nc == 1) fail("grayscale JPEG is not supported (YCbCr only)");
    if (nc != 3)
      fail("JPEG with " + std::to_string(nc) +
           " components is not supported (3-component YCbCr only)");
    if (len < 6 + 3 * nc) fail("bad SOF segment");
    for (int c = 0; c < 3; c++) {
      Component& k = comps_[c];
      k.id = p_[s + 6 + 3 * c];
      k.h = p_[s + 7 + 3 * c] >> 4;
      k.v = p_[s + 7 + 3 * c] & 15;
      k.tq = p_[s + 8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
        fail("bad JPEG sampling factors or table index");
      hmax_ = std::max(hmax_, k.h);
      vmax_ = std::max(vmax_, k.v);
    }
    // libjpeg's default colour space for 3 components (jdapimin.c)
    bool rgb = false;
    if (saw_adobe_ && !saw_jfif_) rgb = adobe_transform_ == 0;
    else if (!saw_jfif_ && comps_[0].id == 'R' && comps_[1].id == 'G' &&
             comps_[2].id == 'B')
      rgb = true;
    if (rgb) fail("RGB-coded JPEG is not supported (YCbCr only)");
    for (int c = 0; c < 3; c++) {
      int rh = hmax_ / comps_[c].h, rv = vmax_ / comps_[c].v;
      bool ok = hmax_ % comps_[c].h == 0 && vmax_ % comps_[c].v == 0 &&
                ((rh == 1 && rv == 1) || (rh == 2 && rv == 1) ||
                 (rh == 2 && rv == 2));
      if (!ok)
        fail("JPEG chroma layout is not supported (4:4:4, 4:2:2 h2v1 and "
             "4:2:0 h2v2 only)");
    }
    mcus_x_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcus_y_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (int c = 0; c < 3; c++) {
      Component& k = comps_[c];
      k.width = (int)(((long)width_ * k.h + hmax_ - 1) / hmax_);
      k.height = (int)(((long)height_ * k.v + vmax_ - 1) / vmax_);
      k.bw = mcus_x_ * k.h;
      k.bh = mcus_y_ * k.v;
    }
    have_frame_ = true;
  }

  void read_dht(size_t s, int len) {
    size_t end = s + len;
    while (s < end) {
      int tc = p_[s] >> 4, th = p_[s] & 15;
      if (tc > 1 || th > 3) fail("bad DHT table class or index");
      if (s + 17 > end) fail("bad DHT segment");
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; l++) {
        bits[l] = p_[s + l];
        count += bits[l];
      }
      if (count > 256 || s + 17 + count > end) fail("bad DHT segment");
      (tc == 0 ? dc_[th] : ac_[th]).build(bits, p_ + s + 17, count);
      s += 17 + count;
    }
  }

  void read_dqt(size_t s, int len) {
    size_t end = s + len;
    while (s < end) {
      int pq = p_[s] >> 4, tq = p_[s] & 15;
      if (pq > 1 || tq > 3) fail("bad DQT precision or index");
      size_t need = 1 + 64 * (pq + 1);
      if (s + need > end) fail("bad DQT segment");
      for (int i = 0; i < 64; i++) {
        int val = pq ? (p_[s + 1 + 2 * i] << 8) | p_[s + 2 + 2 * i]
                     : p_[s + 1 + i];
        qt_[tq][kNatural[i]] = val;
      }
      qt_present_[tq] = true;
      s += need;
    }
  }

  // ---------------------------------------------------------- entropy
  uint32_t bitbuf_ = 0;   // left-aligned
  int bits_ = 0;
  bool marker_hit_ = false;

  void fill() {
    while (bits_ <= 24) {
      uint32_t c = 0;
      if (!marker_hit_) {
        if (pos_ >= n_) fail("JPEG file is truncated inside a scan");
        c = p_[pos_];
        if (c == 0xFF) {
          if (pos_ + 1 >= n_) fail("JPEG file is truncated inside a scan");
          if (p_[pos_ + 1] == 0) {
            pos_ += 2;
          } else {
            // a marker ends the entropy data: libjpeg feeds zeros
            marker_hit_ = true;
            c = 0;
          }
        } else {
          pos_++;
        }
      }
      bitbuf_ |= c << (24 - bits_);
      bits_ += 8;
    }
  }

  int get_bits(int n) {
    if (n == 0) return 0;
    fill();
    int v = (int)(bitbuf_ >> (32 - n));
    bitbuf_ <<= n;
    bits_ -= n;
    return v;
  }

  int decode(const Huffman& h) {
    fill();
    int look = (int)(bitbuf_ >> (32 - kLookBits));
    int l = h.look_len[look];
    if (l) {
      bitbuf_ <<= l;
      bits_ -= l;
      return h.look_val[look];
    }
    int32_t code = (int32_t)(bitbuf_ >> (32 - kLookBits));
    l = kLookBits;
    bitbuf_ <<= kLookBits;
    bits_ -= kLookBits;
    while (code > h.maxcode[l]) {
      code = (code << 1) | get_bits(1);
      if (++l > 16) fail("corrupt JPEG: bad Huffman code");
    }
    return h.huffval[code + h.valoffset[l]];
  }

  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v + (int)((~0u) << s) + 1 : v;
  }

  void decode_block(Component& k, int by, int bx) {
    int16_t* blk = &k.coef[((size_t)by * k.bw + bx) * 64];
    int s = decode(dc_[k.td]);
    if (s > 15) fail("corrupt JPEG: bad DC difference size");
    int diff = s ? extend(get_bits(s), s) : 0;
    k.dc_pred += diff;
    blk[0] = (int16_t)k.dc_pred;
    const Huffman& ac = ac_[k.ta];
    for (int i = 1; i < 64; i++) {
      int rs = decode(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        blk[kNatural[i]] = (int16_t)extend(get_bits(s), s);
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  void restart(int* next_rst) {
    bitbuf_ = 0;
    bits_ = 0;
    if (!marker_hit_) {
      // skip to the marker (libjpeg discards what lies before it)
      while (pos_ + 1 < n_ && !(p_[pos_] == 0xFF && p_[pos_ + 1] != 0 &&
                                p_[pos_ + 1] != 0xFF))
        pos_++;
    }
    if (pos_ + 1 >= n_) fail("JPEG file is truncated inside a scan");
    int m = p_[pos_ + 1];
    if (m != 0xD0 + *next_rst) fail("corrupt JPEG: missing restart marker");
    pos_ += 2;
    marker_hit_ = false;
    *next_rst = (*next_rst + 1) & 7;
    for (auto& k : comps_) k.dc_pred = 0;
  }

  void read_sos(size_t s, int len) {
    if (!have_frame_) fail("corrupt JPEG: SOS before SOF");
    if (scanned_)
      fail("JPEG with several scans is not supported (one interleaved "
           "scan only)");
    int ns = p_[s];
    if (len != 4 + 2 * ns) fail("bad SOS segment");
    if (ns != 3)
      fail("JPEG with non-interleaved scans is not supported (one "
           "interleaved scan only)");
    Component* in_scan[3];
    for (int i = 0; i < ns; i++) {
      int id = p_[s + 1 + 2 * i], t = p_[s + 2 + 2 * i];
      Component* k = nullptr;
      for (auto& c : comps_)
        if (c.id == id) k = &c;
      if (!k) fail("corrupt JPEG: SOS names an unknown component");
      k->td = t >> 4;
      k->ta = t & 15;
      if (k->td > 3 || k->ta > 3 || !dc_[k->td].present ||
          !ac_[k->ta].present)
        fail("corrupt JPEG: scan uses an undefined Huffman table");
      if (!qt_present_[k->tq]) fail("corrupt JPEG: undefined quantization table");
      std::memcpy(k->quant, qt_[k->tq], sizeof(k->quant));
      k->coef.assign((size_t)k->bw * k->bh * 64, 0);
      k->dc_pred = 0;
      in_scan[i] = k;
    }
    int ss = p_[s + 1 + 2 * ns], se = p_[s + 2 + 2 * ns], ah_al = p_[s + 3 + 2 * ns];
    if (ss != 0 || se != 63 || ah_al != 0)
      fail("corrupt JPEG: sequential scan with spectral selection");
    bitbuf_ = 0;
    bits_ = 0;
    marker_hit_ = false;
    int next_rst = 0, todo = restart_interval_;
    auto mcu_done = [&](bool last) {
      if (restart_interval_ && !last) {
        if (--todo == 0) {
          restart(&next_rst);
          todo = restart_interval_;
        }
      }
    };
    for (int my = 0; my < mcus_y_; my++)
      for (int mx = 0; mx < mcus_x_; mx++) {
        for (int i = 0; i < ns; i++) {
          Component& k = *in_scan[i];
          for (int y = 0; y < k.v; y++)
            for (int x = 0; x < k.h; x++)
              decode_block(k, my * k.v + y, mx * k.h + x);
        }
        mcu_done(my == mcus_y_ - 1 && mx == mcus_x_ - 1);
      }
    // back to the marker that ends the scan
    if (!marker_hit_) {
      while (pos_ + 1 < n_ && !(p_[pos_] == 0xFF && p_[pos_ + 1] != 0 &&
                                p_[pos_ + 1] != 0xFF))
        pos_++;
    }
    bitbuf_ = 0;
    bits_ = 0;
    marker_hit_ = false;
    scanned_ = true;
  }

  // ---------------------------------------------------------- IDCT
  static uint8_t idct_limit(int64_t x) {
    // libjpeg's post-IDCT range_limit[x & RANGE_MASK] (jdmaster.c)
    int j = (int)(x & 1023);
    if (j < 128) return (uint8_t)(j + 128);
    if (j < 512) return 255;
    if (j < 896) return 0;
    return (uint8_t)(j - 896);
  }

  static void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out,
                         int stride) {
    // jidctint.c jpeg_idct_islow
    constexpr int CB = 13, P1 = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433,
                      F0765 = 6270, F0899 = 7373, F1175 = 9633,
                      F1501 = 12299, F1847 = 15137, F1961 = 16069,
                      F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto descale = [](int64_t x, int n) {
      return (x + ((int64_t)1 << (n - 1))) >> n;
    };
    int ws[64];
    for (int c = 0; c < 8; c++) {
      const int16_t* ip = in + c;
      const int32_t* qp = q + c;
      int* wp = ws + c;
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
          ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
        int dc = (int)(((int64_t)ip[0] * qp[0]) << P1);
        for (int r = 0; r < 8; r++) wp[8 * r] = dc;
        continue;
      }
      int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = (int64_t)ip[0] * qp[0];
      z3 = (int64_t)ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) << CB;
      int64_t tmp1 = (z2 - z3) << CB;
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = (int64_t)ip[56] * qp[56];
      tmp1 = (int64_t)ip[40] * qp[40];
      tmp2 = (int64_t)ip[24] * qp[24];
      tmp3 = (int64_t)ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      wp[0] = (int)descale(tmp10 + tmp3, CB - P1);
      wp[56] = (int)descale(tmp10 - tmp3, CB - P1);
      wp[8] = (int)descale(tmp11 + tmp2, CB - P1);
      wp[48] = (int)descale(tmp11 - tmp2, CB - P1);
      wp[16] = (int)descale(tmp12 + tmp1, CB - P1);
      wp[40] = (int)descale(tmp12 - tmp1, CB - P1);
      wp[24] = (int)descale(tmp13 + tmp0, CB - P1);
      wp[32] = (int)descale(tmp13 - tmp0, CB - P1);
    }
    for (int r = 0; r < 8; r++) {
      const int* wp = ws + 8 * r;
      uint8_t* op = out + (size_t)r * stride;
      if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 &&
          wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
        uint8_t dc = idct_limit(descale(wp[0], P1 + 3));
        for (int c = 0; c < 8; c++) op[c] = dc;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = ((int64_t)wp[0] + wp[4]) << CB;
      int64_t tmp1 = ((int64_t)wp[0] - wp[4]) << CB;
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      constexpr int S = CB + P1 + 3;
      op[0] = idct_limit(descale(tmp10 + tmp3, S));
      op[7] = idct_limit(descale(tmp10 - tmp3, S));
      op[1] = idct_limit(descale(tmp11 + tmp2, S));
      op[6] = idct_limit(descale(tmp11 - tmp2, S));
      op[2] = idct_limit(descale(tmp12 + tmp1, S));
      op[5] = idct_limit(descale(tmp12 - tmp1, S));
      op[3] = idct_limit(descale(tmp13 + tmp0, S));
      op[4] = idct_limit(descale(tmp13 - tmp0, S));
    }
  }

  // component samples, cropped to (height, width)
  void idct_component(const Component& k, std::vector<uint8_t>& plane) {
    int bw = (k.width + 7) / 8, bh = (k.height + 7) / 8;
    int stride = bw * 8;
    std::vector<uint8_t> full((size_t)stride * bh * 8);
    for (int by = 0; by < bh; by++)
      for (int bx = 0; bx < bw; bx++)
        idct_islow(&k.coef[((size_t)by * k.bw + bx) * 64], k.quant,
                   &full[(size_t)by * 8 * stride + bx * 8], stride);
    plane.resize((size_t)k.width * k.height);
    for (int y = 0; y < k.height; y++)
      std::memcpy(&plane[(size_t)y * k.width], &full[(size_t)y * stride],
                  k.width);
  }

  // ---------------------------------------------------------- upsampling
  // jdsample.c on the component's (height, width) samples; rows above the
  // first and below the last are copies of them (jdmainct.c context rows)
  void upsample(const Component& k, const std::vector<uint8_t>& in,
                std::vector<uint8_t>& out) {
    int rh = hmax_ / k.h, rv = vmax_ / k.v;
    int cw = k.width, ch = k.height;
    int ow = cw * rh, oh = ch * rv;
    std::vector<uint8_t> up((size_t)ow * oh);
    bool fancy = cw > 2;
    if (rh == 1 && rv == 1) {
      up = in;
    } else if (rh == 2 && rv == 1) {
      for (int y = 0; y < ch; y++) {
        const uint8_t* ip = &in[(size_t)y * cw];
        uint8_t* op = &up[(size_t)y * ow];
        if (!fancy) {
          for (int x = 0; x < cw; x++) op[2 * x] = op[2 * x + 1] = ip[x];
          continue;
        }
        int v0 = ip[0];
        op[0] = (uint8_t)v0;
        op[1] = (uint8_t)((v0 * 3 + ip[1] + 2) >> 2);
        for (int x = 1; x < cw - 1; x++) {
          int v = ip[x] * 3;
          op[2 * x] = (uint8_t)((v + ip[x - 1] + 1) >> 2);
          op[2 * x + 1] = (uint8_t)((v + ip[x + 1] + 2) >> 2);
        }
        int vl = ip[cw - 1];
        op[2 * cw - 2] = (uint8_t)((vl * 3 + ip[cw - 2] + 1) >> 2);
        op[2 * cw - 1] = (uint8_t)vl;
      }
    } else {                                     // h2v2
      for (int y = 0; y < ch; y++) {
        const uint8_t* i0 = &in[(size_t)y * cw];
        for (int v = 0; v < 2; v++) {
          uint8_t* op = &up[(size_t)(2 * y + v) * ow];
          if (!fancy) {
            for (int x = 0; x < cw; x++) op[2 * x] = op[2 * x + 1] = i0[x];
            continue;
          }
          int ny = v == 0 ? (y > 0 ? y - 1 : 0) : (y + 1 < ch ? y + 1 : y);
          const uint8_t* i1 = &in[(size_t)ny * cw];
          int this_sum = i0[0] * 3 + i1[0];
          int next_sum = i0[1] * 3 + i1[1];
          op[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
          op[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
          int last_sum = this_sum;
          this_sum = next_sum;
          for (int x = 1; x < cw - 1; x++) {
            next_sum = i0[x + 1] * 3 + i1[x + 1];
            op[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
            op[2 * x + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
            last_sum = this_sum;
            this_sum = next_sum;
          }
          op[2 * cw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
          op[2 * cw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
        }
      }
    }
    // crop to the image
    out.resize((size_t)width_ * height_);
    for (int y = 0; y < height_; y++)
      std::memcpy(&out[(size_t)y * width_], &up[(size_t)y * ow], width_);
  }

  // ---------------------------------------------------------- colour
  void color_convert(const std::vector<uint8_t> planes[3], uint8_t* out) {
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    constexpr int SB = 16;
    constexpr int64_t HALF = (int64_t)1 << (SB - 1);
    auto fix = [](double x) { return (int64_t)(x * (1L << SB) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    size_t n = (size_t)width_ * height_;
    for (size_t i = 0; i < n; i++) {
      int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> SB));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

void copy_error(const char* msg, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, (size_t)errlen, "%s", msg);
}

}  // namespace

extern "C" int ivos_jpeg_size(const uint8_t* data, size_t n, int* height,
                              int* width, char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.read_header();
    *height = d.height();
    *width = d.width();
    return 0;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}

extern "C" int ivos_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out,
                                int height, int width, char* err,
                                int errlen) {
  try {
    Decoder d(data, n);
    d.read_header();
    if (d.height() != height || d.width() != width)
      throw JpegError("output buffer does not match the image size");
    d.decode(out);
    return 0;
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
    return 1;
  }
}
