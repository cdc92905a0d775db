// Native host-side runtime for mfcc_jax: WAV decode, threaded batch data
// loading, and the framed wire protocols.
//
// This is the equivalent of the reference's C host inventory
// (SURVEY.md section 2.6):
//   * WAV reading            -- software/libwav submodule + main.c:56-98
//   * stream packetization   -- main.c:128-165 (32-bit words, low int16 =
//                               sample, bit 31 = soft reset)
//   * magic resynchronization-- serial.c:89-122 (hunt 0xa5 0x5a), and
//                               big-endian column decode cepstrum.c:15-91
//   * batch directory walk   -- main.c:206-247 (here: threaded loader that
//                               feeds the JAX batch pipeline)
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Error codes
// ---------------------------------------------------------------------------
enum {
  MFCC_OK = 0,
  MFCC_ERR_OPEN = -1,
  MFCC_ERR_FORMAT = -2,
  MFCC_ERR_ALLOC = -3,
  MFCC_ERR_ARG = -4,
};

void mfcc_free(void *p) { free(p); }

// ---------------------------------------------------------------------------
// WAV decode (RIFF PCM16 / PCM8 / IEEE float32; first channel)
// ---------------------------------------------------------------------------

static uint32_t rd_u32(const uint8_t *p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t *p) {
  return (uint16_t)(p[0] | (p[1] << 8));
}

// Decode a WAV file into int16 mono samples (first channel).
// On success *out is malloc'd (caller frees with mfcc_free).
int mfcc_wav_read(const char *path, int16_t **out, int64_t *n_samples,
                  int32_t *sample_rate) {
  if (!path || !out || !n_samples || !sample_rate) return MFCC_ERR_ARG;
  FILE *f = fopen(path, "rb");
  if (!f) return MFCC_ERR_OPEN;

  // actual file size: chunk sizes are attacker-controlled 32-bit values and
  // must be validated against it before any allocation
  fseek(f, 0, SEEK_END);
  int64_t file_size = ftell(f);
  fseek(f, 0, SEEK_SET);

  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) ||
      memcmp(hdr + 8, "WAVE", 4)) {
    fclose(f);
    return MFCC_ERR_FORMAT;
  }

  uint16_t audio_fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  int64_t nsamp = 0;
  int16_t *buf = nullptr;

  uint8_t ck[8];
  while (fread(ck, 1, 8, f) == 8) {
    uint32_t cksize = rd_u32(ck + 4);
    if (!memcmp(ck, "fmt ", 4)) {
      uint8_t fmt[16];
      if (cksize < 16 || fread(fmt, 1, 16, f) != 16) {
        fclose(f);
        free(buf);
        return MFCC_ERR_FORMAT;
      }
      audio_fmt = rd_u16(fmt);
      channels = rd_u16(fmt + 2);
      rate = rd_u32(fmt + 4);
      bits = rd_u16(fmt + 14);
      if (cksize > 16) fseek(f, cksize - 16, SEEK_CUR);
    } else if (!memcmp(ck, "data", 4)) {
      // reject malformed fmt before the division: bits in 1..7 passes a
      // !bits check but makes bytes_per 0 -> SIGFPE (round-1 ADVICE, medium)
      if (!channels || !bits || (bits % 8) != 0) {
        fclose(f);
        free(buf);
        return MFCC_ERR_FORMAT;
      }
      uint32_t bytes_per = (bits / 8) * channels;
      if (bytes_per == 0) {
        fclose(f);
        free(buf);
        return MFCC_ERR_FORMAT;
      }
      // clamp the declared chunk size to the bytes actually present, so a
      // corrupt 32-bit cksize cannot drive a multi-GiB allocation
      int64_t remaining = file_size - (int64_t)ftell(f);
      if (remaining < 0) remaining = 0;
      if ((int64_t)cksize > remaining) cksize = (uint32_t)remaining;
      nsamp = cksize / bytes_per;
      buf = (int16_t *)malloc(sizeof(int16_t) * (size_t)nsamp);
      if (!buf) {
        fclose(f);
        return MFCC_ERR_ALLOC;
      }
      std::vector<uint8_t> raw(cksize);
      size_t got = fread(raw.data(), 1, cksize, f);
      int64_t n = (int64_t)(got / bytes_per);
      if ((audio_fmt == 1 || audio_fmt == 0xFFFE) && bits == 16) {
        for (int64_t i = 0; i < n; i++)
          buf[i] = (int16_t)rd_u16(&raw[(size_t)i * bytes_per]);
      } else if (audio_fmt == 1 && bits == 8) {
        for (int64_t i = 0; i < n; i++)
          buf[i] = (int16_t)(((int)raw[(size_t)i * bytes_per] - 128) << 8);
      } else if (audio_fmt == 3 && bits == 32) {  // IEEE float
        for (int64_t i = 0; i < n; i++) {
          float v;
          memcpy(&v, &raw[(size_t)i * bytes_per], 4);
          float s = v * 32767.0f;
          if (s > 32767.f) s = 32767.f;
          if (s < -32768.f) s = -32768.f;
          buf[i] = (int16_t)s;
        }
      } else {
        fclose(f);
        free(buf);
        return MFCC_ERR_FORMAT;
      }
      nsamp = n;
      break;
    } else {
      fseek(f, (cksize + 1) & ~1u, SEEK_CUR);  // chunks are word-aligned
    }
  }
  fclose(f);
  if (!buf) return MFCC_ERR_FORMAT;
  *out = buf;
  *n_samples = nsamp;
  *sample_rate = (int32_t)rate;
  return MFCC_OK;
}

// ---------------------------------------------------------------------------
// Threaded batch loader: decode many wavs into one fixed-shape int16 matrix
// (n_files x max_samples, zero padded) -- the data loader that feeds the
// batched device pipeline.
// ---------------------------------------------------------------------------

int mfcc_wav_read_batch(const char **paths, int32_t n_files,
                        int16_t *out,        // (n_files * max_samples)
                        int64_t max_samples, // truncate/pad to this
                        int64_t *lengths,    // per-file true sample counts
                        int32_t *rates,      // per-file sample rates
                        int32_t n_threads) {
  if (!paths || !out || !lengths || !rates || n_files < 0) return MFCC_ERR_ARG;
  if (n_threads <= 0) n_threads = (int32_t)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 4;
  std::atomic<int32_t> next(0);
  std::atomic<int> err(MFCC_OK);

  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n_files) return;
      int16_t *samples = nullptr;
      int64_t n = 0;
      int32_t rate = 0;
      int rc = mfcc_wav_read(paths[i], &samples, &n, &rate);
      if (rc != MFCC_OK) {
        lengths[i] = 0;
        rates[i] = 0;
        int expected = MFCC_OK;
        err.compare_exchange_strong(expected, rc);
        continue;
      }
      int64_t keep = n < max_samples ? n : max_samples;
      memcpy(out + (size_t)i * max_samples, samples,
             sizeof(int16_t) * (size_t)keep);
      memset(out + (size_t)i * max_samples + keep, 0,
             sizeof(int16_t) * (size_t)(max_samples - keep));
      lengths[i] = keep;
      rates[i] = rate;
      free(samples);
    }
  };

  std::vector<std::thread> ts;
  int32_t nt = n_threads < n_files ? n_threads : (n_files ? n_files : 1);
  for (int32_t t = 0; t < nt; t++) ts.emplace_back(worker);
  for (auto &t : ts) t.join();
  return err.load();
}

// ---------------------------------------------------------------------------
// Sample-stream wire protocol (USB3 link format, software/main.c:128-151):
// each 32-bit word carries one int16 sample in its low half; a word with
// bit 31 set is a soft reset (main.c:21-34).
// ---------------------------------------------------------------------------

int64_t mfcc_encode_stream_words(const int16_t *samples, int64_t n,
                                 int reset_first, uint32_t *out) {
  int64_t w = 0;
  if (reset_first) out[w++] = 0x80000000u;
  for (int64_t i = 0; i < n; i++) out[w++] = (uint32_t)(uint16_t)samples[i];
  return w;
}

// Decode words -> samples; reset events set resets[i]=1 for the position in
// the OUTPUT sample stream where a reset occurred (before that sample).
// A trailing reset (no following sample in this buffer) is reported as
// resets[s]=1 at the one-past-the-end position (s = return value; safe since
// a reset word consumed an input slot, so s < n) -- callers must carry it,
// matching transport.decode_stream's trailing_reset flag.
int64_t mfcc_decode_stream_words(const uint32_t *words, int64_t n,
                                 int16_t *samples, uint8_t *resets) {
  int64_t s = 0;
  int pending_reset = 0;
  for (int64_t i = 0; i < n; i++) {
    if (words[i] & 0x80000000u) {
      pending_reset = 1;
      continue;
    }
    samples[s] = (int16_t)(words[i] & 0xFFFFu);
    resets[s] = (uint8_t)pending_reset;
    pending_reset = 0;
    s++;
  }
  if (pending_reset && s < n) resets[s] = 1;
  return s;
}

// ---------------------------------------------------------------------------
// Magic-framed feature protocol (UART link format):
// each frame is 0xa55a then ncep big-endian int16 coefficients
// (mfcc/misc/magic.py:9-41, mic2mfcc.py:56-74 big-endian serializer).
// ---------------------------------------------------------------------------

// Scan for the 0xa5 0x5a delimiter; returns byte index just AFTER the magic,
// or -1 (serial.c:89-122 expect_magic hunts byte-by-byte, resynchronizing
// after any byte loss).
int64_t mfcc_magic_sync(const uint8_t *buf, int64_t n) {
  for (int64_t i = 0; i + 1 < n; i++)
    if (buf[i] == 0xa5 && buf[i + 1] == 0x5a) return i + 2;
  return -1;
}

// Encode frames (n_frames x ncep int16) into the magic-framed big-endian
// byte stream.  out must hold n_frames * (2 + 2*ncep) bytes.
int64_t mfcc_encode_frames(const int16_t *cep, int64_t n_frames, int32_t ncep,
                           uint8_t *out) {
  int64_t o = 0;
  for (int64_t fidx = 0; fidx < n_frames; fidx++) {
    out[o++] = 0xa5;
    out[o++] = 0x5a;
    for (int32_t c = 0; c < ncep; c++) {
      uint16_t v = (uint16_t)cep[fidx * ncep + c];
      out[o++] = (uint8_t)(v >> 8);  // big-endian (ntohs, cepstrum.c:40)
      out[o++] = (uint8_t)(v & 0xFF);
    }
  }
  return o;
}

// Decode a magic-framed byte stream into columns, resynchronizing on magic.
// Returns number of complete frames decoded; *consumed = bytes consumed up
// to the start of the first incomplete frame (so callers can stream).
int64_t mfcc_decode_frames(const uint8_t *buf, int64_t n, int32_t ncep,
                           int16_t *cep, int64_t max_frames,
                           int64_t *consumed) {
  int64_t frames = 0;
  int64_t pos = 0;
  *consumed = 0;
  while (frames < max_frames) {
    int64_t after = mfcc_magic_sync(buf + pos, n - pos);
    if (after < 0) {
      // no magic left; everything scanned except a possible trailing 0xa5
      *consumed = n > 0 ? n - 1 : 0;
      return frames;
    }
    int64_t start = pos + after;
    if (start + 2 * ncep > n) {
      *consumed = pos + after - 2;  // keep the magic for next round
      return frames;
    }
    for (int32_t c = 0; c < ncep; c++) {
      uint16_t hi = buf[start + 2 * c];
      uint16_t lo = buf[start + 2 * c + 1];
      cep[frames * ncep + c] = (int16_t)((hi << 8) | lo);
    }
    frames++;
    pos = start + 2 * ncep;
    *consumed = pos;
  }
  return frames;
}

}  // extern "C"
