// fe_native — native host-IO core for the shard/data pipeline.
//
// A copy of fastenhancer_tpu/native/fe_native.cpp (the port imports nothing
// of the JAX package). It is the host runtime beside the card's kernels:
// the loader loop that walks plain-ustar shard tars and decodes RIFF/WAVE
// members (PCM 8/16/24/32-bit and IEEE float 32/64) to float32 mono in a
// single pass, without per-member Python or intermediate numpy copies. It
// mirrors the Python implementations in fastenhancer_tpu_torch/data/shard.py
// (_iter_tar_audio / _decode_audio) and data/audio_io.py (_read_riff),
// which stay as the fallback (FE_NATIVE=0, or no g++); equality is asserted
// in tests/test_torch_native.py.
//
// Concurrency model: one ShardReader handle per producer thread, no shared
// state — calls release the GIL on the Python side, so N producer threads
// decode on N cores.
//
// Build: g++ -O3 -shared -fPIC at first use (fastenhancer_tpu_torch/native/
// __init__.py). Bindings: ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------- wav decode

struct WavInfo {
  int fmt = 0;       // 1 = PCM, 3 = IEEE float (extensible resolved)
  int n_ch = 0;
  int sr = 0;
  int bits = 0;
  const uint8_t* pcm = nullptr;
  size_t pcm_size = 0;
  int64_t frames = 0;  // samples per channel after decode
};

// Parse RIFF/WAVE chunks. Chunk-walk semantics match audio_io._read_riff:
// scan fmt / data, skip others with odd-size padding, stop once both found.
// Returns 0 ok, -4 malformed/unsupported.
int parse_wav(const uint8_t* buf, size_t n, WavInfo* w) {
  if (n < 12 || memcmp(buf, "RIFF", 4) != 0 || memcmp(buf + 8, "WAVE", 4) != 0)
    return -4;
  size_t pos = 12;
  const uint8_t* fmt_p = nullptr;
  size_t fmt_n = 0;
  while (pos + 8 <= n) {
    uint32_t size;
    memcpy(&size, buf + pos + 4, 4);
    const uint8_t* cid = buf + pos;
    size_t body = pos + 8;
    if (body > n) break;
    size_t avail = n - body;
    size_t take = size < avail ? size : avail;  // tolerate truncated tail
    if (memcmp(cid, "fmt ", 4) == 0) {
      fmt_p = buf + body;
      fmt_n = take;
    } else if (memcmp(cid, "data", 4) == 0) {
      w->pcm = buf + body;
      w->pcm_size = take;
    }
    pos = body + size + (size & 1);
    if (fmt_p && w->pcm) break;
  }
  if (!fmt_p || fmt_n < 16 || !w->pcm) return -4;
  uint16_t audio_fmt, n_ch, bits;
  uint32_t sr;
  memcpy(&audio_fmt, fmt_p + 0, 2);
  memcpy(&n_ch, fmt_p + 2, 2);
  memcpy(&sr, fmt_p + 4, 4);
  memcpy(&bits, fmt_p + 14, 2);
  if (audio_fmt == 0xFFFE && fmt_n >= 26)  // WAVE_FORMAT_EXTENSIBLE
    memcpy(&audio_fmt, fmt_p + 24, 2);
  if (n_ch == 0) return -4;
  w->fmt = audio_fmt;
  w->n_ch = n_ch;
  w->sr = static_cast<int>(sr);
  w->bits = bits;
  int bytes_per;
  if (audio_fmt == 1) {
    if (bits != 8 && bits != 16 && bits != 24 && bits != 32) return -4;
    bytes_per = bits / 8;
  } else if (audio_fmt == 3) {
    if (bits != 32 && bits != 64) return -4;
    bytes_per = bits / 8;
  } else {
    return -4;
  }
  // np.frombuffer errors on a buffer that is not a whole number of samples;
  // a short/odd data chunk must fail here too so both decode paths agree
  if (w->pcm_size % (size_t)(bytes_per * n_ch) != 0) return -4;
  w->frames = static_cast<int64_t>(w->pcm_size / (size_t)(bytes_per * n_ch));
  return 0;
}

inline float sample_at(const WavInfo& w, int64_t frame, int ch) {
  const uint8_t* p;
  switch (w.fmt == 3 ? (w.bits == 32 ? 100 : 101) : w.bits) {
    case 16: {
      int16_t v;
      memcpy(&v, w.pcm + 2 * (frame * w.n_ch + ch), 2);
      return static_cast<float>(v) / 32768.0f;
    }
    case 32: {
      int32_t v;
      memcpy(&v, w.pcm + 4 * (frame * w.n_ch + ch), 4);
      return static_cast<float>(static_cast<double>(v) / 2147483648.0);
    }
    case 24: {
      p = w.pcm + 3 * (frame * w.n_ch + ch);
      int32_t v = (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
      if (v >= (1 << 23)) v -= (1 << 24);
      return static_cast<float>(v) / 8388608.0f;
    }
    case 8: {
      return (static_cast<float>(w.pcm[frame * w.n_ch + ch]) - 128.0f) /
             128.0f;
    }
    case 100: {  // IEEE float32
      float v;
      memcpy(&v, w.pcm + 4 * (frame * w.n_ch + ch), 4);
      return v;
    }
    case 101: {  // IEEE float64
      double v;
      memcpy(&v, w.pcm + 8 * (frame * w.n_ch + ch), 8);
      return static_cast<float>(v);
    }
  }
  return 0.0f;
}

// Decode to float32; multi-channel is mean-downmixed (float32 accumulation,
// matching numpy's float32 mean for the stereo shards we produce).
void decode_to(const WavInfo& w, float* out) {
  const int64_t n = w.frames;
  if (w.n_ch == 1) {
    // fast contiguous paths for the common mono formats
    if (w.fmt == 1 && w.bits == 16) {
      const uint8_t* p = w.pcm;
      for (int64_t i = 0; i < n; ++i) {
        int16_t v;
        memcpy(&v, p + 2 * i, 2);
        out[i] = static_cast<float>(v) / 32768.0f;
      }
      return;
    }
    if (w.fmt == 3 && w.bits == 32) {
      memcpy(out, w.pcm, sizeof(float) * (size_t)n);
      return;
    }
    for (int64_t i = 0; i < n; ++i) out[i] = sample_at(w, i, 0);
    return;
  }
  const int c = w.n_ch;
  const float inv = 1.0f / static_cast<float>(c);
  for (int64_t i = 0; i < n; ++i) {
    float acc = 0.0f;
    for (int ch = 0; ch < c; ++ch) acc += sample_at(w, i, ch);
    out[i] = acc * inv;
  }
}

// ---------------------------------------------------------------- tar walking

struct ShardReader {
  FILE* f = nullptr;
  std::vector<uint8_t> scratch;  // current member payload
  std::string name;              // current member name
  int64_t payload_off = 0;       // file offset of current payload
  int64_t payload_size = 0;
  bool pending = false;  // payload parsed, waiting for a big-enough out buffer
  bool is_wav = false;
};

// Octal size field (bytes 124..136), NUL/space terminated — the plain-ustar
// subset; callers gate pax/GNU tars to the Python tarfile path beforehand
// (ShardSource._plain_ustar), same contract as the Python fast walker.
int64_t parse_octal(const uint8_t* p, int n) {
  int64_t v = 0;
  bool any = false;
  for (int i = 0; i < n; ++i) {
    uint8_t c = p[i];
    if (c == 0 || c == ' ') {
      if (any) break;
      continue;
    }
    if (c < '0' || c > '7') return -1;
    v = v * 8 + (c - '0');
    any = true;
  }
  return v;
}

// Exactly '.wav' or '.WAV' — the same set _decode_audio (data/shard.py:64)
// accepts; mixed-case suffixes must flow through the payload path on both.
bool has_wav_suffix(const std::string& s) {
  auto ends = [&](const char* suf) {
    size_t m = strlen(suf);
    return s.size() >= m && s.compare(s.size() - m, m, suf) == 0;
  };
  return ends(".wav") || ends(".WAV");
}

}  // namespace

extern "C" {

// Status codes shared with the Python bindings:
//   0 wav member decoded into `out` (*n_out = sample count)
//   1 end of archive
//   2 non-wav member: payload held natively, fetch via fe_shard_payload
//      (*n_out = payload byte size)
//  -2 `out` too small for the decoded wav (*n_out = required float count;
//      the member stays pending — call again with a bigger buffer)
//  -4 member named *.wav but malformed/unsupported RIFF
//  -5 malformed tar (bad header/truncated payload)
//  -6 non-regular member (mixed-format tar; rebuild with uniform ustar)

void* fe_shard_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new ShardReader();
  r->f = f;
  return r;
}

void fe_shard_close(void* h) {
  auto* r = static_cast<ShardReader*>(h);
  if (!r) return;
  if (r->f) fclose(r->f);
  delete r;
}

int fe_shard_next(void* h, float* out, int64_t cap, char* name_buf,
                  int name_cap, int64_t* n_out, int* sr_out) {
  auto* r = static_cast<ShardReader*>(h);
  if (!r || !r->f) return -5;

  if (!r->pending) {
    // advance to the next regular member
    uint8_t header[512];
    for (;;) {
      size_t got = fread(header, 1, 512, r->f);
      if (got < 512 || header[0] == 0) return 1;  // eof / terminator block
      uint8_t type = header[156];
      if (!(type == '0' || type == 0)) return -6;
      int64_t size = parse_octal(header + 124, 12);
      if (size < 0) return -5;
      r->name.assign(reinterpret_cast<char*>(header),
                     strnlen(reinterpret_cast<char*>(header), 100));
      r->payload_off = ftello(r->f);
      r->payload_size = size;
      r->scratch.resize(static_cast<size_t>(size));
      if (size > 0 &&
          fread(r->scratch.data(), 1, static_cast<size_t>(size), r->f) !=
              static_cast<size_t>(size))
        return -5;
      int64_t pad = (512 - size % 512) % 512;
      if (pad) fseeko(r->f, pad, SEEK_CUR);
      break;
    }
    r->is_wav = has_wav_suffix(r->name);
    r->pending = true;
  }

  if (name_buf && name_cap > 0) {
    int m = static_cast<int>(r->name.size());
    if (m >= name_cap) m = name_cap - 1;
    memcpy(name_buf, r->name.data(), static_cast<size_t>(m));
    name_buf[m] = 0;
  }

  if (!r->is_wav) {
    *n_out = r->payload_size;
    return 2;  // payload stays pending for fe_shard_payload
  }

  WavInfo w;
  int rc = parse_wav(r->scratch.data(), r->scratch.size(), &w);
  if (rc != 0) {
    r->pending = false;
    return rc;
  }
  if (sr_out) *sr_out = w.sr;
  if (w.frames > cap) {
    *n_out = w.frames;
    return -2;  // still pending; caller retries with a bigger buffer
  }
  decode_to(w, out);
  *n_out = w.frames;
  r->pending = false;
  return 0;
}

// Fetch the pending non-wav payload (after status 2). Returns bytes copied,
// or -1 if nothing is pending / cap too small.
int64_t fe_shard_payload(void* h, uint8_t* out, int64_t cap) {
  auto* r = static_cast<ShardReader*>(h);
  if (!r || !r->pending || static_cast<int64_t>(r->scratch.size()) > cap)
    return -1;
  memcpy(out, r->scratch.data(), r->scratch.size());
  r->pending = false;
  return static_cast<int64_t>(r->scratch.size());
}

// Standalone file decode (paired-wav datasets): decode whole file to float32
// mono. Returns 0 ok, -2 buffer too small (*n_out = required), -1 IO error,
// -4 malformed.
int fe_read_wav_file(const char* path, float* out, int64_t cap,
                     int64_t* n_out, int* sr_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseeko(f, 0, SEEK_END);
  int64_t fsize = ftello(f);
  fseeko(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(static_cast<size_t>(fsize));
  if (fsize > 0 &&
      fread(buf.data(), 1, static_cast<size_t>(fsize), f) !=
          static_cast<size_t>(fsize)) {
    fclose(f);
    return -1;
  }
  fclose(f);
  WavInfo w;
  int rc = parse_wav(buf.data(), buf.size(), &w);
  if (rc != 0) return rc;
  if (sr_out) *sr_out = w.sr;
  *n_out = w.frames;
  if (w.frames > cap) return -2;
  decode_to(w, out);
  return 0;
}

int fe_native_abi(void) { return 1; }

}  // extern "C"
