// Native TIFF stack codec for rescan_line_sted_torch.
//
// The reference has no native code (SURVEY.md section 2.3), so none is owed
// for parity; this is the rebuild's host-side native runtime path: baseline
// little-endian TIFF stacks encoded in one pass with page payloads copied on
// a small thread pool. End-to-end file writes are disk-bound either way (the
// pure-Python writer keeps up with the disk); the native path matters for
// in-memory encoding of many stacks. Exposed through ctypes (io/native/);
// byte-identical to the pure-Python writer in io/tiff.py, which remains the
// fallback and the format oracle.
//
// Build (io/native/loader.py does this at first use, into the build
// directory): g++ -O3 -shared -fPIC -o _tiff_fast.so tiff_fast.cpp -lpthread

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint16_t kTypeShort = 3;
constexpr uint16_t kTypeLong = 4;
constexpr int kNumEntries = 9;
constexpr size_t kIfdSize = 2 + kNumEntries * 12 + 4;

struct __attribute__((packed)) Entry {
  uint16_t tag;
  uint16_t type;
  uint32_t count;
  uint32_t value;
};

void put_entry(uint8_t*& p, uint16_t tag, uint16_t type, uint32_t value) {
  Entry e{tag, type, 1, value};
  std::memcpy(p, &e, sizeof(e));
  p += sizeof(e);
}

}  // namespace

extern "C" {

// Total encoded size for an [n, h, w] stack with `itemsize`-byte samples.
uint64_t tiff_encoded_size(uint32_t n, uint32_t h, uint32_t w,
                           uint32_t itemsize) {
  return 8ull + n * (kIfdSize + (uint64_t)h * w * itemsize);
}

// Encode `data` ([n, h, w], C-contiguous) into `out` (caller-allocated,
// tiff_encoded_size bytes). sample_format: 1 = unsigned int, 3 = IEEE float.
// Returns 0 on success.
int tiff_encode(const uint8_t* data, uint32_t n, uint32_t h, uint32_t w,
                uint32_t itemsize, uint32_t sample_format, uint8_t* out,
                int num_threads) {
  const uint64_t page_bytes = (uint64_t)h * w * itemsize;
  uint8_t* p = out;
  // header: "II", 42, first IFD offset = 8
  const uint8_t header[8] = {'I', 'I', 42, 0, 8, 0, 0, 0};
  std::memcpy(p, header, 8);

  // Write all IFDs serially (tiny), payload copies in parallel below.
  for (uint32_t i = 0; i < n; ++i) {
    uint64_t ifd_off = 8ull + i * (kIfdSize + page_bytes);
    uint64_t data_off = ifd_off + kIfdSize;
    uint64_t next_ifd = (i + 1 < n) ? data_off + page_bytes : 0;
    uint8_t* q = out + ifd_off;
    uint16_t cnt = kNumEntries;
    std::memcpy(q, &cnt, 2);
    q += 2;
    put_entry(q, 256, kTypeLong, w);                     // ImageWidth
    put_entry(q, 257, kTypeLong, h);                     // ImageLength
    put_entry(q, 258, kTypeShort, itemsize * 8);         // BitsPerSample
    put_entry(q, 259, kTypeShort, 1);                    // Compression
    put_entry(q, 262, kTypeShort, 1);                    // Photometric
    put_entry(q, 273, kTypeLong, (uint32_t)data_off);    // StripOffsets
    put_entry(q, 278, kTypeLong, h);                     // RowsPerStrip
    put_entry(q, 279, kTypeLong, (uint32_t)page_bytes);  // StripByteCounts
    put_entry(q, 339, kTypeShort, sample_format);        // SampleFormat
    uint32_t next32 = (uint32_t)next_ifd;
    std::memcpy(q, &next32, 4);
  }

  if (num_threads < 1) num_threads = 1;
  if ((uint32_t)num_threads > n) num_threads = n;
  std::vector<std::thread> workers;
  workers.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    workers.emplace_back([=]() {
      for (uint32_t i = t; i < n; i += num_threads) {
        uint64_t data_off = 8ull + i * (kIfdSize + page_bytes) + kIfdSize;
        std::memcpy(out + data_off, data + (uint64_t)i * page_bytes,
                    page_bytes);
      }
    });
  }
  for (auto& th : workers) th.join();
  return 0;
}

}  // extern "C"
