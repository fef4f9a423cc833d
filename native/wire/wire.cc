// Native wire codec: turns the device's truncated-DCT frame coefficients
// into muxer-ready pixels and containers with no Python-side pixel work.
//
// The device side of the wire format lives in text2video/ops/dct.py:
// each YUV420 plane leaves the device as the first K zigzag coefficients
// of an orthonormal 8x8 DCT, quantized with JPEG-style tables, as int8.
// The host-side decode sits on the streaming path between the device
// and the muxer. This library provides:
//
//   * t2v_wire_decode_bgr — fused dequantize + IDCT + chroma upsample +
//     BT.601 video-range YUV->BGR (matching cv2's I420 conversion and
//     ops/colorspace.py's forward matrix), one pass per frame, for the
//     cv2 VideoWriter path.
//   * t2v_wire_to_jpeg — assembles baseline JFIF images DIRECTLY from
//     the quantized coefficients (entropy coding only, no IDCT, no
//     recompression) for the self-contained MJPEG-AVI muxer
//     (io/video.py). The wire carries BT.601 *video-range* planes while
//     JFIF is full-range; the encoder rescales in the coefficient
//     domain (an affine map touches only the DC term plus a per-AC
//     scale), so the JPEGs decode to the same RGB as the BGR path.
//
// Huffman tables are our own fixed-length canonical codes (4-bit DC
// symbols, 8-bit AC symbols) declared in the DHT segment — valid
// baseline JPEG, chosen for encoder simplicity and robustness over
// optimal size (these bytes go to disk, not over the wire).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

inline uint8_t clamp_u8(float v) {
  if (v <= 0.0f) return 0;
  if (v >= 255.0f) return 255;
  return static_cast<uint8_t>(v + 0.5f);
}

// Decode one plane of truncated zigzag coefficients into uint8 pixels.
// coeffs: [nb_y, nb_x, k] int8 (zigzag order), kern: [k][64] row-major
// dequant+IDCT kernel (the same matrix ops/dct.py::_decode_kernel
// builds, so both decoders agree bit-for-bit up to rounding).
void decode_plane(const int8_t* coeffs, int nb_y, int nb_x, int k,
                  const float* kern, uint8_t* out, int stride) {
  std::vector<float> acc(64);
  for (int by = 0; by < nb_y; ++by) {
    for (int bx = 0; bx < nb_x; ++bx) {
      const int8_t* c = coeffs + (static_cast<int64_t>(by) * nb_x + bx) * k;
      std::memset(acc.data(), 0, 64 * sizeof(float));
      for (int i = 0; i < k; ++i) {
        const float ci = static_cast<float>(c[i]);
        if (ci == 0.0f) continue;
        const float* kr = kern + i * 64;
        for (int p = 0; p < 64; ++p) acc[p] += ci * kr[p];
      }
      uint8_t* o = out + (static_cast<int64_t>(by) * 8) * stride + bx * 8;
      for (int r = 0; r < 8; ++r)
        for (int cx = 0; cx < 8; ++cx)
          o[static_cast<int64_t>(r) * stride + cx] =
              clamp_u8(acc[r * 8 + cx] + 128.0f);
    }
  }
}

// ---- bit writer for the JPEG entropy segment --------------------------
//
// Writes into a caller-provided raw buffer (the caller bounds capacity
// with the 160-bytes-per-block worst case before encoding a frame).
// Bits accumulate in a 64-bit register and leave four bytes at a time;
// the stuffing check runs once per word on the no-0xff fast path
// (encoding is the host-side cost of every streamed frame — see
// StreamingMuxer — and the byte-at-a-time writer was ~38 ns/byte).

struct BitWriter {
  uint8_t* p;
  uint64_t buf = 0;
  int nbits = 0;

  inline void put(uint32_t bits, int n) {
    buf = (buf << n) | (bits & ((1u << n) - 1u));
    nbits += n;
    if (nbits >= 32) {
      uint32_t v = static_cast<uint32_t>(buf >> (nbits - 32));
      // any byte == 0xff?  (x ^ ~0) has a zero byte iff x has an 0xff.
      uint32_t x = ~v;
      if (((x - 0x01010101u) & ~x & 0x80808080u) == 0) {
        p[0] = static_cast<uint8_t>(v >> 24);
        p[1] = static_cast<uint8_t>(v >> 16);
        p[2] = static_cast<uint8_t>(v >> 8);
        p[3] = static_cast<uint8_t>(v);
        p += 4;
      } else {
        for (int i = 3; i >= 0; --i) {
          uint8_t b = static_cast<uint8_t>((v >> (8 * i)) & 0xff);
          *p++ = b;
          if (b == 0xff) *p++ = 0x00;  // byte stuffing
        }
      }
      nbits -= 32;
      buf &= (1ull << nbits) - 1ull;
    }
  }
  void flush() {
    while (nbits >= 8) {
      uint8_t b = static_cast<uint8_t>((buf >> (nbits - 8)) & 0xff);
      *p++ = b;
      if (b == 0xff) *p++ = 0x00;
      nbits -= 8;
    }
    if (nbits > 0) {
      uint8_t b = static_cast<uint8_t>(
          ((buf << (8 - nbits)) | ((1u << (8 - nbits)) - 1u)) & 0xff);
      *p++ = b;  // pad with 1s
      if (b == 0xff) *p++ = 0x00;
      nbits = 0;
    }
    buf = 0;
  }
};

inline int bit_size(int v) {
  unsigned a = static_cast<unsigned>(v < 0 ? -v : v);
  return a ? 32 - __builtin_clz(a) : 0;
}

// Fixed-length canonical Huffman codes: DC symbols 0..11 at 4 bits
// (codes 0..11; the all-ones code 15 stays unused as required), AC
// symbols at 8 bits in a fixed order (EOB, ZRL, then (run,size) for
// run 0..15 x size 1..10; 162 symbols, codes 0..161, all-ones unused).
struct AcTable {
  uint8_t order[256];   // symbol -> code (also the HUFFVAL order)
  int count = 0;
  uint8_t huffval[176];
  AcTable() {
    std::memset(order, 0xff, sizeof(order));
    auto add = [&](int sym) {
      order[sym] = static_cast<uint8_t>(count);
      huffval[count++] = static_cast<uint8_t>(sym);
    };
    add(0x00);  // EOB
    add(0xf0);  // ZRL
    for (int run = 0; run < 16; ++run)
      for (int size = 1; size <= 10; ++size) add((run << 4) | size);
  }
};

const AcTable& ac_table() {
  static AcTable t;
  return t;
}

void encode_block(BitWriter& bw, const int* z /*>=k zigzag ints*/, int k,
                  int& dc_pred) {
  // DC: 4-bit category code + category bits.
  int diff = z[0] - dc_pred;
  dc_pred = z[0];
  int s = bit_size(diff);
  bw.put(static_cast<uint32_t>(s), 4);
  if (s) bw.put(static_cast<uint32_t>(diff < 0 ? diff + (1 << s) - 1 : diff), s);
  // AC: run-length + 8-bit (run,size) symbol + bits; EOB after the last
  // nonzero. k is the WIRE truncation length — everything past it is
  // zero by construction, so the scan stops there (scanning all 64
  // slots cost ~400k wasted iterations per frame at k=12/6).
  const AcTable& t = ac_table();
  int last = 0;
  for (int i = 1; i < k; ++i)
    if (z[i]) last = i;
  int run = 0;
  for (int i = 1; i <= last; ++i) {
    if (z[i] == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(t.order[0xf0], 8);
      run -= 16;
    }
    int as = bit_size(z[i]);
    bw.put(t.order[(run << 4) | as], 8);
    bw.put(static_cast<uint32_t>(z[i] < 0 ? z[i] + (1 << as) - 1 : z[i]), as);
    run = 0;
  }
  if (last != 63) bw.put(t.order[0x00], 8);  // EOB
}

void put_u16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xff));
}

void put_marker(std::vector<uint8_t>& o, uint8_t m) {
  o.push_back(0xff);
  o.push_back(m);
}

// Video-range -> full-range rescale factors (JFIF is full-range).
const float kYScale = 255.0f / 219.0f;
const float kCScale = 255.0f / 224.0f;
// Constant offset folded into the luma DC term: pixels stored on the
// wire are (Y_vid - 128); JFIF reconstructs IDCT + 128, and matching
// 1.164*(Y_vid - 16) requires DC += 8 * (1.164*128 - 18.62 - 128).
const float kYDcOffset = 8.0f * (kYScale * 128.0f - 16.0f * kYScale - 128.0f);

// Requantize one block from wire quant steps to header quant steps with
// the full-range rescale. zq: k wire coefficients; q: wire quant table
// (zigzag-ordered steps); out: 64 ints.
void requant_block(const int8_t* zq, int k, const float* qz, float scale,
                   float dc_offset, int* out) {
  // Only out[0..k) is ever read back (encode_block bounds its AC scan
  // at the wire truncation length), so no tail zeroing is needed.
  for (int i = 0; i < k; ++i) {
    float f = static_cast<float>(zq[i]) * qz[i] * scale;
    if (i == 0) f += dc_offset;
    float q = f / qz[i];
    out[i] = static_cast<int>(q < 0 ? q - 0.5f : q + 0.5f);
  }
}

}  // namespace

extern "C" {

// Unpack the per-block-shift bit-packed wire (ops/dct.py::
// pack_plane_shift layout: per field — DC 8 bits, shift 2 bits, each
// AC w_ac bits — MSB-first bit planes of one byte per 8 blocks) back
// into plain int8 coefficients with the block shift folded in
// (identical output contract to ops/dct.py::unpack_plane_shift_np).
// buf: m*(10+(k-1)*w_ac) bytes with m = ceil(n_blocks/8);
// out: n_blocks*k int8. Returns 0, or -1 on bad parameters.
int t2v_wire_unpack(const uint8_t* buf, int64_t n_blocks, int k, int w_ac,
                    int8_t* out) {
  if (k < 1 || w_ac < 2 || w_ac > 8 || n_blocks <= 0) return -1;
  const int64_t m = (n_blocks + 7) / 8;
  const int64_t n_pad = m * 8;
  const int lim = (1 << (w_ac - 1)) - 1;
  std::vector<int> vals(n_pad);
  const uint8_t* p = buf;
  auto read_field = [&](int w) {
    std::fill(vals.begin(), vals.end(), 0);
    for (int b = 0; b < w; ++b) {
      const int shift = w - 1 - b;
      for (int64_t i = 0; i < m; ++i) {
        const uint8_t byte = p[i];
        for (int j = 0; j < 8; ++j)
          vals[i * 8 + j] |= ((byte >> (7 - j)) & 1) << shift;
      }
      p += m;
    }
  };
  read_field(8);
  for (int64_t i = 0; i < n_blocks; ++i)
    out[i * k] = static_cast<int8_t>(vals[i] - 128);
  std::vector<int> sh(n_pad);
  read_field(2);
  sh = vals;
  for (int c = 1; c < k; ++c) {
    read_field(w_ac);
    for (int64_t i = 0; i < n_blocks; ++i)
      out[i * k + c] =
          static_cast<int8_t>((vals[i] - (lim + 1)) << sh[i]);
  }
  return 0;
}

// Fused coefficient->BGR decode. yc/uc/vc: zigzag-truncated int8
// coefficients, [n, yhb, ywb, kl] and [n, chb, cwb, kc]; lkern/ckern:
// [k][64] dequant+IDCT kernels (ops/dct.py::_decode_kernel layout);
// out: [n, h, w, 3] uint8 BGR. Returns 0.
int t2v_wire_decode_bgr(const int8_t* yc, const int8_t* uc, const int8_t* vc,
                        int n, int yhb, int ywb, int chb, int cwb, int kl,
                        int kc, const float* lkern, const float* ckern, int h,
                        int w, uint8_t* out) {
  const int ys = ywb * 8, cs = cwb * 8;
  std::vector<uint8_t> yp(static_cast<size_t>(yhb) * 8 * ys);
  std::vector<uint8_t> up(static_cast<size_t>(chb) * 8 * cs);
  std::vector<uint8_t> vp(up.size());
  const int64_t yblk = static_cast<int64_t>(yhb) * ywb * kl;
  const int64_t cblk = static_cast<int64_t>(chb) * cwb * kc;
  for (int f = 0; f < n; ++f) {
    decode_plane(yc + f * yblk, yhb, ywb, kl, lkern, yp.data(), ys);
    decode_plane(uc + f * cblk, chb, cwb, kc, ckern, up.data(), cs);
    decode_plane(vc + f * cblk, chb, cwb, kc, ckern, vp.data(), cs);
    uint8_t* o = out + static_cast<int64_t>(f) * h * w * 3;
    for (int i = 0; i < h; ++i) {
      const uint8_t* yr = yp.data() + static_cast<int64_t>(i) * ys;
      const uint8_t* ur = up.data() + static_cast<int64_t>(i / 2) * cs;
      const uint8_t* vr = vp.data() + static_cast<int64_t>(i / 2) * cs;
      uint8_t* orow = o + static_cast<int64_t>(i) * w * 3;
      for (int j = 0; j < w; ++j) {
        // BT.601 video-range inverse (cv2 COLOR_YUV2BGR_I420 constants).
        float c = 1.164f * (static_cast<float>(yr[j]) - 16.0f);
        float d = static_cast<float>(ur[j / 2]) - 128.0f;
        float e = static_cast<float>(vr[j / 2]) - 128.0f;
        orow[j * 3 + 0] = clamp_u8(c + 2.017f * d);             // B
        orow[j * 3 + 1] = clamp_u8(c - 0.392f * d - 0.813f * e);  // G
        orow[j * 3 + 2] = clamp_u8(c + 1.596f * e);             // R
      }
    }
  }
  return 0;
}

// Assemble one baseline JFIF per frame straight from the wire
// coefficients (no pixel-domain work). lq/cq: the wire quant tables as
// 64 row-major floats (ops/dct.py::quant_tables); h/w: true pixel dims.
// JPEGs are written back-to-back into out (capacity cap); sizes[f]
// receives each frame's byte length. Returns total bytes, or -1 if cap
// would overflow.
int64_t t2v_wire_to_jpeg(const int8_t* yc, const int8_t* uc, const int8_t* vc,
                         int n, int yhb, int ywb, int chb, int cwb, int kl,
                         int kc, const float* lq, const float* cq, int h,
                         int w, uint8_t* out, int64_t cap, int64_t* sizes) {
  // Zigzag-ordered integer header tables == the wire steps (they are
  // integral by construction, ops/dct.py::quant_tables).
  uint8_t lqz[64], cqz[64];
  float lqzf[64], cqzf[64];
  for (int i = 0; i < 64; ++i) {
    float lv = lq[kZigzag[i]], cv = cq[kZigzag[i]];
    lqz[i] = static_cast<uint8_t>(lv < 1 ? 1 : (lv > 255 ? 255 : lv));
    cqz[i] = static_cast<uint8_t>(cv < 1 ? 1 : (cv > 255 ? 255 : cv));
    lqzf[i] = static_cast<float>(lqz[i]);
    cqzf[i] = static_cast<float>(cqz[i]);
  }
  const AcTable& act = ac_table();
  const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  const int64_t yblk = static_cast<int64_t>(yhb) * ywb * kl;
  const int64_t cblk = static_cast<int64_t>(chb) * cwb * kc;
  int64_t total = 0;
  // Header bytes are identical for every frame — build once, memcpy per
  // frame; only the entropy segment is re-encoded.
  std::vector<uint8_t> frame;
  {
    put_marker(frame, 0xd8);  // SOI
    for (int t = 0; t < 2; ++t) {  // DQT x2
      put_marker(frame, 0xdb);
      put_u16(frame, 67);
      frame.push_back(static_cast<uint8_t>(t));
      const uint8_t* q = t == 0 ? lqz : cqz;
      frame.insert(frame.end(), q, q + 64);
    }
    put_marker(frame, 0xc0);  // SOF0: 4:2:0, 3 components
    put_u16(frame, 17);
    frame.push_back(8);
    put_u16(frame, h);
    put_u16(frame, w);
    frame.push_back(3);
    const uint8_t sof[] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
    frame.insert(frame.end(), sof, sof + 9);
    // DHT: one DC table (12 symbols at 4 bits) and one AC table
    // (162 symbols at 8 bits), each declared for both table ids so
    // luma and chroma share them.
    for (int id = 0; id < 2; ++id) {
      put_marker(frame, 0xc4);
      put_u16(frame, 2 + 1 + 16 + 12);
      frame.push_back(static_cast<uint8_t>(id));  // DC table id
      for (int i = 1; i <= 16; ++i)
        frame.push_back(i == 4 ? 12 : 0);
      for (int s = 0; s < 12; ++s) frame.push_back(static_cast<uint8_t>(s));
      put_marker(frame, 0xc4);
      put_u16(frame, 2 + 1 + 16 + act.count);
      frame.push_back(static_cast<uint8_t>(0x10 | id));  // AC table id
      for (int i = 1; i <= 16; ++i)
        frame.push_back(i == 8 ? static_cast<uint8_t>(act.count) : 0);
      frame.insert(frame.end(), act.huffval, act.huffval + act.count);
    }
    put_marker(frame, 0xda);  // SOS
    put_u16(frame, 12);
    frame.push_back(3);
    const uint8_t sos[] = {1, 0x00, 2, 0x11, 3, 0x11};
    frame.insert(frame.end(), sos, sos + 6);
    frame.push_back(0);
    frame.push_back(63);
    frame.push_back(0);
  }
  // Exact worst case per frame (the raw writer has no per-byte bounds
  // checks): a block emits at most 15 DC + 18*k AC bits, and byte
  // stuffing can at most double the bytes.
  auto worst_block = [](int k) { return 2 * ((15 + 18 * k + 7) / 8); };
  const int64_t frame_cap =
      static_cast<int64_t>(mcuy) * mcux *
          (4 * worst_block(kl) + 2 * worst_block(kc)) +
      static_cast<int64_t>(frame.size()) + 8;
  for (int f = 0; f < n; ++f) {
    if (total + frame_cap > cap) return -1;
    uint8_t* fp = out + total;
    std::memcpy(fp, frame.data(), frame.size());
    BitWriter bw{fp + frame.size()};
    int dc[3] = {0, 0, 0};
    int z[64];
    const int8_t* yf = yc + f * yblk;
    const int8_t* uf = uc + f * cblk;
    const int8_t* vf = vc + f * cblk;
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        for (int sy = 0; sy < 2; ++sy) {
          for (int sx = 0; sx < 2; ++sx) {
            int by = my * 2 + sy, bx = mx * 2 + sx;
            if (by >= yhb) by = yhb - 1;  // edge clamp for odd grids
            if (bx >= ywb) bx = ywb - 1;
            requant_block(yf + (static_cast<int64_t>(by) * ywb + bx) * kl,
                          kl, lqzf, kYScale, kYDcOffset, z);
            encode_block(bw, z, kl, dc[0]);
          }
        }
        int cy = my >= chb ? chb - 1 : my, cx = mx >= cwb ? cwb - 1 : mx;
        requant_block(uf + (static_cast<int64_t>(cy) * cwb + cx) * kc, kc,
                      cqzf, kCScale, 0.0f, z);
        encode_block(bw, z, kc, dc[1]);
        requant_block(vf + (static_cast<int64_t>(cy) * cwb + cx) * kc, kc,
                      cqzf, kCScale, 0.0f, z);
        encode_block(bw, z, kc, dc[2]);
      }
    }
    bw.flush();
    *bw.p++ = 0xff;  // EOI
    *bw.p++ = 0xd9;
    sizes[f] = static_cast<int64_t>(bw.p - fp);
    total += sizes[f];
  }
  return total;
}

}  // extern "C"
