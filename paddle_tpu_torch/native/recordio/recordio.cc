// Chunked record file format — the durable on-disk story of the data
// plane. Reference capability: paddle/fluid/recordio/{chunk,header,
// scanner,writer} (chunk.h:26, header.h:39) — chunked, checksummed,
// optionally-compressed byte records. This is a fresh design, not a
// port: little-endian fixed header, whole-chunk DEFLATE, CRC32 over the
// RAW payload so corruption is caught after decompression too. The
// PyTorch port's copy of paddle_tpu/native/recordio/recordio.cc: files
// written by either package are the same bytes.
//
// Layout:
//   file  := chunk*
//   chunk := magic(4)="PTRC" | version(u8)=1 | compressor(u8)
//          | num_records(u32) | raw_len(u64) | comp_len(u64)
//          | crc32(u32 over raw payload) | payload[comp_len]
//   raw payload := (rec_len(u32) | rec_bytes)*
// Compressors: 0 = none, 1 = zlib DEFLATE.
//
// C ABI for ctypes (no pybind11 in this image): every function returns
// 0/handle on success; rio_last_error() describes the latest failure.

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

constexpr char kMagic[4] = {'P', 'T', 'R', 'C'};
constexpr uint8_t kVersion = 1;
constexpr size_t kHeaderSize = 4 + 1 + 1 + 4 + 8 + 8 + 4;

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

void put_u32(std::string* out, uint32_t v) {
  for (int i = 0; i < 4; ++i) out->push_back(char((v >> (8 * i)) & 0xff));
}
void put_u64(std::string* out, uint64_t v) {
  for (int i = 0; i < 8; ++i) out->push_back(char((v >> (8 * i)) & 0xff));
}
uint32_t get_u32(const unsigned char* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}
uint64_t get_u64(const unsigned char* p) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; --i) v = (v << 8) | p[i];
  return v;
}

struct Writer {
  FILE* f = nullptr;
  int compressor = 1;          // default DEFLATE
  size_t max_chunk_bytes = 1 << 20;
  std::string raw;             // pending raw payload
  uint32_t num_records = 0;
  uint64_t total_records = 0;

  bool flush_chunk() {
    if (num_records == 0) return true;
    uint32_t crc =
        crc32(0L, reinterpret_cast<const Bytef*>(raw.data()), raw.size());
    std::string payload;
    int comp = compressor;
    if (comp == 1) {
      uLongf bound = compressBound(raw.size());
      payload.resize(bound);
      if (compress2(reinterpret_cast<Bytef*>(&payload[0]), &bound,
                    reinterpret_cast<const Bytef*>(raw.data()), raw.size(),
                    Z_DEFAULT_COMPRESSION) != Z_OK) {
        set_error("deflate failed");
        return false;
      }
      payload.resize(bound);
    } else {
      payload = raw;
    }
    std::string header;
    header.append(kMagic, 4);
    header.push_back(char(kVersion));
    header.push_back(char(comp));
    put_u32(&header, num_records);
    put_u64(&header, raw.size());
    put_u64(&header, payload.size());
    put_u32(&header, crc);
    if (fwrite(header.data(), 1, header.size(), f) != header.size() ||
        fwrite(payload.data(), 1, payload.size(), f) != payload.size()) {
      set_error("short write");
      return false;
    }
    raw.clear();
    num_records = 0;
    return true;
  }
};

struct Scanner {
  FILE* f = nullptr;
  std::string raw;           // current chunk raw payload
  size_t pos = 0;            // cursor into raw
  uint32_t remaining = 0;    // records left in current chunk
  std::string record;        // last record (returned pointer target)

  bool load_chunk() {
    unsigned char hdr[kHeaderSize];
    size_t n = fread(hdr, 1, kHeaderSize, f);
    if (n == 0) {
      if (ferror(f)) {
        set_error("read error in chunk header");
      }
      return false;  // clean EOF only when !ferror
    }
    if (n != kHeaderSize || memcmp(hdr, kMagic, 4) != 0) {
      set_error("corrupt chunk header");
      return false;
    }
    uint8_t version = hdr[4];
    uint8_t comp = hdr[5];
    if (version != kVersion) {
      set_error("unsupported version");
      return false;
    }
    uint32_t num = get_u32(hdr + 6);
    uint64_t raw_len = get_u64(hdr + 10);
    uint64_t comp_len = get_u64(hdr + 18);
    uint32_t crc = get_u32(hdr + 26);
    // corrupt length bytes must become errors, not multi-GB allocations
    // that throw through the C ABI and abort the process
    constexpr uint64_t kMaxChunk = 1ull << 31;
    if (raw_len > kMaxChunk || comp_len > kMaxChunk ||
        (comp == 0 && comp_len != raw_len)) {
      set_error("corrupt chunk header (implausible lengths)");
      return false;
    }
    std::string payload(comp_len, '\0');
    if (fread(&payload[0], 1, comp_len, f) != comp_len) {
      set_error("truncated chunk payload");
      return false;
    }
    if (comp == 1) {
      raw.resize(raw_len);
      uLongf out_len = raw_len;
      if (uncompress(reinterpret_cast<Bytef*>(&raw[0]), &out_len,
                     reinterpret_cast<const Bytef*>(payload.data()),
                     comp_len) != Z_OK ||
          out_len != raw_len) {
        set_error("inflate failed");
        return false;
      }
    } else {
      raw = std::move(payload);
      if (raw.size() != raw_len) {
        set_error("raw length mismatch");
        return false;
      }
    }
    uint32_t got =
        crc32(0L, reinterpret_cast<const Bytef*>(raw.data()), raw.size());
    if (got != crc) {
      set_error("chunk CRC mismatch");
      return false;
    }
    pos = 0;
    remaining = num;
    return true;
  }
};

}  // namespace

extern "C" {

const char* rio_last_error() { return g_error.c_str(); }

void* rio_writer_open(const char* path, int compressor,
                      uint64_t max_chunk_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) {
    set_error(std::string("cannot open for write: ") + path);
    return nullptr;
  }
  Writer* w = new Writer();
  w->f = f;
  w->compressor = compressor;
  if (max_chunk_bytes) w->max_chunk_bytes = max_chunk_bytes;
  return w;
}

int rio_writer_write(void* handle, const char* buf, uint64_t len) {
  Writer* w = static_cast<Writer*>(handle);
  if (len > 0xffffffffull) {
    set_error("record too large (u32 length prefix)");
    return -1;
  }
  try {  // bad_alloc etc. must not unwind through the C ABI
    put_u32(&w->raw, uint32_t(len));
    w->raw.append(buf, len);
    w->num_records += 1;
    w->total_records += 1;
    if (w->raw.size() >= w->max_chunk_bytes) {
      if (!w->flush_chunk()) return -1;
    }
  } catch (const std::exception& e) {
    set_error(std::string("write failed: ") + e.what());
    return -1;
  }
  return 0;
}

uint64_t rio_writer_close(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  uint64_t total = w->total_records;
  bool ok = false;
  try {
    ok = w->flush_chunk();
  } catch (const std::exception& e) {
    set_error(std::string("flush failed: ") + e.what());
  }
  fclose(w->f);
  delete w;
  return ok ? total : uint64_t(-1);
}

void* rio_scanner_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    set_error(std::string("cannot open for read: ") + path);
    return nullptr;
  }
  Scanner* s = new Scanner();
  s->f = f;
  return s;
}

// Returns pointer to the next record (valid until the next call) and sets
// *len; nullptr at EOF (*len = 0) or on error (*len = uint64 max).
const char* rio_scanner_next(void* handle, uint64_t* len) {
  Scanner* s = static_cast<Scanner*>(handle);
  if (s->remaining == 0) {
    // the header's num_records is outside the payload CRC: an understated
    // count would silently drop trailing records unless the cursor is
    // checked against the chunk end here
    if (!s->raw.empty() && s->pos != s->raw.size()) {
      set_error("trailing bytes in chunk (corrupt record count)");
      *len = uint64_t(-1);
      return nullptr;
    }
    g_error.clear();
    bool ok = false;
    try {
      ok = s->load_chunk();
    } catch (const std::exception& e) {  // never unwind through the C ABI
      set_error(std::string("chunk load failed: ") + e.what());
    }
    if (!ok) {
      *len = g_error.empty() ? 0 : uint64_t(-1);
      return nullptr;
    }
  }
  if (s->pos + 4 > s->raw.size()) {
    set_error("corrupt record length");
    *len = uint64_t(-1);
    return nullptr;
  }
  uint32_t rec_len =
      get_u32(reinterpret_cast<const unsigned char*>(s->raw.data()) + s->pos);
  s->pos += 4;
  if (s->pos + rec_len > s->raw.size()) {
    set_error("corrupt record payload");
    *len = uint64_t(-1);
    return nullptr;
  }
  s->record.assign(s->raw, s->pos, rec_len);
  s->pos += rec_len;
  s->remaining -= 1;
  *len = rec_len;
  return s->record.data();
}

void rio_scanner_close(void* handle) {
  Scanner* s = static_cast<Scanner*>(handle);
  fclose(s->f);
  delete s;
}

}  // extern "C"
