// TFRecord bulk scanner with hardware CRC32C.
//
// The Python reader (clipa_tpu/data/tfrecord.py) is the portable fallback;
// this scanner indexes record (offset, length) pairs at IO speed and
// verifies CRCs with SSE4.2 when available — what the reference got from
// tf.data's C++ readers.
//
// Exported C API (ctypes):
//   tfr_scan(path, offsets_out, lengths_out, cap, verify) -> n_records
//     (call with cap=0 to count records first)
//   crc32c(buf, len) -> masked crc (for tests)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

uint32_t crc_table[256];
bool table_init = false;

void init_table() {
  if (table_init) return;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j)
      crc = (crc >> 1) ^ (0x82F63B78u & (~(crc & 1) + 1));
    crc_table[i] = crc;
  }
  table_init = true;
}

uint32_t crc32c_sw(const uint8_t* data, size_t n) {
  init_table();
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i)
    crc = crc_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

uint32_t crc32c_raw(const uint8_t* data, size_t n) {
#if defined(__SSE4_2__)
  uint64_t crc = 0xFFFFFFFFu;
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t chunk;
    std::memcpy(&chunk, data + i, 8);
    crc = _mm_crc32_u64(crc, chunk);
  }
  for (; i < n; ++i) crc = _mm_crc32_u8((uint32_t)crc, data[i]);
  return (uint32_t)crc ^ 0xFFFFFFFFu;
#else
  return crc32c_sw(data, n);
#endif
}

inline uint32_t mask_crc(uint32_t crc) {
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

}  // namespace

extern "C" {

uint32_t tfr_crc32c_masked(const uint8_t* buf, int64_t len) {
  return mask_crc(crc32c_raw(buf, (size_t)len));
}

// Scans a TFRecord file, filling (offset, length) of each record payload.
// Returns record count, or -1 on IO error, -2 on corruption.
int64_t tfr_scan(const char* path, int64_t* offsets_out, int64_t* lengths_out,
                 int64_t cap, int verify) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int64_t n = 0;
  uint8_t header[12];
  std::vector<uint8_t> payload;
  for (;;) {
    size_t got = std::fread(header, 1, 12, f);
    if (got == 0) break;
    if (got < 12) {
      std::fclose(f);
      return -2;
    }
    uint64_t length;
    uint32_t len_crc;
    std::memcpy(&length, header, 8);
    std::memcpy(&len_crc, header + 8, 4);
    if (verify && mask_crc(crc32c_raw(header, 8)) != len_crc) {
      std::fclose(f);
      return -2;
    }
    int64_t offset = (int64_t)std::ftell(f);
    if (verify) {
      payload.resize(length);
      if (std::fread(payload.data(), 1, length, f) != length) {
        std::fclose(f);
        return -2;
      }
      uint8_t crc_buf[4];
      if (std::fread(crc_buf, 1, 4, f) != 4) {
        std::fclose(f);
        return -2;
      }
      uint32_t data_crc;
      std::memcpy(&data_crc, crc_buf, 4);
      if (mask_crc(crc32c_raw(payload.data(), length)) != data_crc) {
        std::fclose(f);
        return -2;
      }
    } else {
      if (std::fseek(f, (long)(length + 4), SEEK_CUR) != 0) {
        std::fclose(f);
        return -2;
      }
    }
    if (n < cap) {
      offsets_out[n] = offset;
      lengths_out[n] = (int64_t)length;
    }
    ++n;
  }
  std::fclose(f);
  return n;
}

}  // extern "C"
