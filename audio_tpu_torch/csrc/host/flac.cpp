// Native FLAC decoder (RFC 9639 bitstream), host code of audio_tpu_torch.io.
//
// The same decoder as the JAX package's io/csrc/flac.cpp.  torchaudio routes
// FLAC through torchcodec/FFmpeg; this package decodes it itself, so FLAC
// corpora (LibriSpeech, Libri-Light) load with no codec library.  Built with
// g++ at first use and loaded through ctypes (audio_tpu_torch/io/_flac.py),
// as the CTC decoder's host core is.
//
// Supports: all block sizes, 8/12/16/20/24/32-bit, 1-8 channels,
// constant / verbatim / fixed(0-4) / LPC(1-32) subframes, rice & rice2
// residual coding with escape partitions, wasted bits, and
// left-side / right-side / mid-side stereo decorrelation. Frame CRCs are
// parsed but not verified (decode speed; torchcodec doesn't verify either).

#include <cstdint>
#include <cstring>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;       // bytes
  size_t pos;        // bit position
  bool error;

  explicit BitReader(const uint8_t* d, size_t n) : data(d), size(n), pos(0), error(false) {}

  inline bool eof() const { return pos >= size * 8; }

  inline uint32_t bit() {
    if (pos >= size * 8) { error = true; return 0; }
    uint32_t b = (data[pos >> 3] >> (7 - (pos & 7))) & 1u;
    ++pos;
    return b;
  }

  // up to 32 bits, MSB first
  inline uint64_t bits(int n) {
    uint64_t v = 0;
    // fast path: byte-aligned whole bytes
    while (n >= 8 && (pos & 7) == 0) {
      if ((pos >> 3) >= size) { error = true; return 0; }
      v = (v << 8) | data[pos >> 3];
      pos += 8;
      n -= 8;
    }
    for (int i = 0; i < n; ++i) v = (v << 1) | bit();
    return v;
  }

  inline int64_t sbits(int n) {  // signed, two's complement
    uint64_t v = bits(n);
    uint64_t sign = 1ull << (n - 1);
    return (v & sign) ? (int64_t)(v | ~((sign << 1) - 1)) : (int64_t)v;
  }

  inline uint32_t unary() {  // count 0 bits until a 1
    uint32_t q = 0;
    while (true) {
      if (pos >= size * 8) { error = true; return q; }
      // fast path: whole zero bytes
      if ((pos & 7) == 0) {
        while ((pos >> 3) < size && data[pos >> 3] == 0) { q += 8; pos += 8; }
      }
      if (bit()) return q;
      ++q;
      if (q > 1u << 24) { error = true; return q; }  // corrupt stream guard
    }
  }

  inline void align() { pos = (pos + 7) & ~size_t(7); }
};

const int kFixedOrders = 5;

// UTF-8-style coded number in frame headers (up to 36 bits)
uint64_t read_utf8(BitReader& br) {
  uint64_t b0 = br.bits(8);
  int extra;
  uint64_t v;
  if ((b0 & 0x80) == 0) { return b0; }
  else if ((b0 & 0xE0) == 0xC0) { extra = 1; v = b0 & 0x1F; }
  else if ((b0 & 0xF0) == 0xE0) { extra = 2; v = b0 & 0x0F; }
  else if ((b0 & 0xF8) == 0xF0) { extra = 3; v = b0 & 0x07; }
  else if ((b0 & 0xFC) == 0xF8) { extra = 4; v = b0 & 0x03; }
  else if ((b0 & 0xFE) == 0xFC) { extra = 5; v = b0 & 0x01; }
  else if (b0 == 0xFE) { extra = 6; v = 0; }
  else { br.error = true; return 0; }
  for (int i = 0; i < extra; ++i) v = (v << 6) | (br.bits(8) & 0x3F);
  return v;
}

struct StreamInfo {
  uint32_t sample_rate = 0;
  int channels = 0;
  int bits = 0;
  uint64_t total_samples = 0;
  size_t audio_start = 0;  // byte offset of first frame
};

bool parse_metadata(const uint8_t* data, size_t size, StreamInfo* si) {
  if (size < 42 || memcmp(data, "fLaC", 4) != 0) return false;
  size_t pos = 4;
  bool last = false;
  bool have_si = false;
  while (!last && pos + 4 <= size) {
    uint8_t hdr = data[pos];
    last = (hdr & 0x80) != 0;
    int type = hdr & 0x7F;
    uint32_t len = (uint32_t(data[pos + 1]) << 16) | (uint32_t(data[pos + 2]) << 8) | data[pos + 3];
    pos += 4;
    if (pos + len > size) return false;
    if (type == 0 && len >= 34) {  // STREAMINFO
      const uint8_t* p = data + pos;
      si->sample_rate = (uint32_t(p[10]) << 12) | (uint32_t(p[11]) << 4) | (p[12] >> 4);
      si->channels = ((p[12] >> 1) & 0x7) + 1;
      si->bits = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
      si->total_samples = ((uint64_t)(p[13] & 0x0F) << 32) | (uint64_t(p[14]) << 24) |
                          (uint64_t(p[15]) << 16) | (uint64_t(p[16]) << 8) | p[17];
      have_si = true;
    }
    pos += len;
  }
  si->audio_start = pos;
  return have_si && pos < size;
}

// residual decoding into out[order..blocksize)
bool read_residual(BitReader& br, int order, int blocksize, int64_t* out) {
  int method = (int)br.bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  int po = (int)br.bits(4);
  int partitions = 1 << po;
  if (blocksize % partitions != 0) return false;
  int psize = blocksize >> po;
  int idx = order;
  for (int p = 0; p < partitions; ++p) {
    int count = psize - (p == 0 ? order : 0);
    if (count < 0) return false;
    uint32_t param = (uint32_t)br.bits(plen);
    if (param == escape) {
      int rawbits = (int)br.bits(5);
      for (int i = 0; i < count; ++i)
        out[idx++] = rawbits ? br.sbits(rawbits) : 0;
    } else {
      for (int i = 0; i < count; ++i) {
        uint64_t q = br.unary();
        uint64_t u = (q << param) | br.bits((int)param);
        out[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
    if (br.error) return false;
  }
  return idx == blocksize;
}

bool decode_subframe(BitReader& br, int blocksize, int bps, int64_t* out) {
  if (br.bit() != 0) return false;  // zero pad bit
  int type = (int)br.bits(6);
  int wasted = 0;
  if (br.bit()) wasted = (int)br.unary() + 1;
  bps -= wasted;
  if (bps <= 0 || bps > 33) return false;

  if (type == 0) {  // CONSTANT
    int64_t v = br.sbits(bps);
    for (int i = 0; i < blocksize; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i) out[i] = br.sbits(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED
    int order = type - 8;
    if (order > blocksize) return false;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(bps);
    if (!read_residual(br, order, blocksize, out)) return false;
    switch (order) {
      case 0: break;
      case 1:
        for (int i = 1; i < blocksize; ++i) out[i] += out[i - 1];
        break;
      case 2:
        for (int i = 2; i < blocksize; ++i) out[i] += 2 * out[i - 1] - out[i - 2];
        break;
      case 3:
        for (int i = 3; i < blocksize; ++i) out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
        break;
      case 4:
        for (int i = 4; i < blocksize; ++i)
          out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4];
        break;
      default:
        return false;
    }
  } else if (type >= 32) {  // LPC
    int order = type - 31;
    if (order > blocksize) return false;
    for (int i = 0; i < order; ++i) out[i] = br.sbits(bps);
    int prec = (int)br.bits(4);
    if (prec == 15) return false;
    prec += 1;
    int shift = (int)br.sbits(5);
    if (shift < 0) return false;
    int64_t coef[32];
    for (int i = 0; i < order; ++i) coef[i] = br.sbits(prec);
    if (!read_residual(br, order, blocksize, out)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j) pred += coef[j] * out[i - 1 - j];
      out[i] += pred >> shift;
    }
  } else {
    return false;  // reserved
  }
  if (wasted) {
    for (int i = 0; i < blocksize; ++i) out[i] <<= wasted;
  }
  return !br.error;
}

const uint32_t kBlockSizes[16] = {0, 192, 576, 1152, 2304, 4608, 0, 0,
                                  256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
const uint32_t kRates[16] = {0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
                             32000, 44100, 48000, 96000, 0, 0, 0, 0};

}  // namespace

extern "C" {

// out_info: [0]=sample_rate [1]=channels [2]=bits [3]=total_lo [4]=total_hi
int flac_probe(const uint8_t* data, int64_t size, int32_t* out_info) {
  StreamInfo si;
  if (!parse_metadata(data, (size_t)size, &si)) return -1;
  out_info[0] = (int32_t)si.sample_rate;
  out_info[1] = si.channels;
  out_info[2] = si.bits;
  out_info[3] = (int32_t)(si.total_samples & 0xFFFFFFFFu);
  out_info[4] = (int32_t)(si.total_samples >> 32);
  return 0;
}

// Decodes the whole stream into `out` (interleaved int32, capacity in
// samples*channels). Returns 0 on success; out_written = frames decoded.
int flac_decode(const uint8_t* data, int64_t size, int32_t* out,
                int64_t out_capacity, int64_t* out_written) {
  StreamInfo si;
  if (!parse_metadata(data, (size_t)size, &si)) return -1;
  const int nch = si.channels;
  BitReader br(data, (size_t)size);
  br.pos = si.audio_start * 8;

  // per-channel scratch (heap; max blocksize 65535)
  static thread_local int64_t* chan[8] = {nullptr};
  static thread_local int chan_cap = 0;

  int64_t frames_out = 0;
  while (true) {
    // skip any zero padding / find sync
    br.align();
    if ((br.pos >> 3) >= br.size) break;
    uint32_t sync = (uint32_t)br.bits(14);
    if (br.error) break;
    if (sync != 0x3FFE) return -2;  // lost sync
    br.bit();  // reserved
    br.bit();  // blocking strategy
    int bs_code = (int)br.bits(4);
    int sr_code = (int)br.bits(4);
    int ch_code = (int)br.bits(4);
    int ss_code = (int)br.bits(3);
    br.bit();  // reserved
    read_utf8(br);
    uint32_t blocksize;
    if (bs_code == 6) blocksize = (uint32_t)br.bits(8) + 1;
    else if (bs_code == 7) blocksize = (uint32_t)br.bits(16) + 1;
    else blocksize = kBlockSizes[bs_code];
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    br.bits(8);  // CRC-8
    if (blocksize == 0 || br.error) return -3;

    int bps;
    switch (ss_code) {
      case 0: bps = si.bits; break;
      case 1: bps = 8; break;
      case 2: bps = 12; break;
      case 4: bps = 16; break;
      case 5: bps = 20; break;
      case 6: bps = 24; break;
      case 7: bps = 32; break;
      default: return -3;
    }

    int nsub = ch_code < 8 ? ch_code + 1 : 2;
    if (nsub != nch) return -4;

    if ((int)blocksize > chan_cap) {
      for (int c = 0; c < 8; ++c) { delete[] chan[c]; chan[c] = nullptr; }
      for (int c = 0; c < nch; ++c) chan[c] = new int64_t[blocksize];
      chan_cap = blocksize;
    } else {
      for (int c = 0; c < nch; ++c) if (!chan[c]) chan[c] = new int64_t[chan_cap];
    }

    for (int c = 0; c < nsub; ++c) {
      int sub_bps = bps;
      if ((ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) || (ch_code == 10 && c == 1))
        sub_bps += 1;  // side channel carries one extra bit
      if (!decode_subframe(br, (int)blocksize, sub_bps, chan[c])) return -5;
    }
    br.align();
    br.bits(16);  // CRC-16

    // undo stereo decorrelation
    if (ch_code == 8) {  // left/side
      for (uint32_t i = 0; i < blocksize; ++i) chan[1][i] = chan[0][i] - chan[1][i];
    } else if (ch_code == 9) {  // right/side: ch0=side, ch1=right
      for (uint32_t i = 0; i < blocksize; ++i) chan[0][i] = chan[0][i] + chan[1][i];
    } else if (ch_code == 10) {  // mid/side
      for (uint32_t i = 0; i < blocksize; ++i) {
        int64_t mid = chan[0][i], side = chan[1][i];
        mid = (mid << 1) | (side & 1);
        chan[0][i] = (mid + side) >> 1;
        chan[1][i] = (mid - side) >> 1;
      }
    }

    if ((frames_out + blocksize) * nch > out_capacity) return -6;
    for (uint32_t i = 0; i < blocksize; ++i)
      for (int c = 0; c < nch; ++c)
        out[(frames_out + i) * nch + c] = (int32_t)chan[c][i];
    frames_out += blocksize;
    if (si.total_samples && (uint64_t)frames_out >= si.total_samples) break;
  }
  *out_written = frames_out;
  return 0;
}

}  // extern "C"
