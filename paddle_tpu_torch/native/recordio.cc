// RecordIO: chunked record file format with CRC32 integrity.
//
// Native-parity component: the reference implements its record file format
// and scanner in C++ (reference: paddle/fluid/recordio/{chunk,writer,
// scanner}.cc). This is a fresh format, not a port:
//   chunk := MAGIC 'PTRC' | u32 n_records | u64 payload_len | u32 crc32
//            | payload
//   payload := repeat{ u32 len | bytes }
// Exposed through a C ABI consumed via ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x43525450;  // 'PTRC' little-endian

uint32_t crc32_table[256];
bool crc_init_done = false;

void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc32_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t crc32(const char* buf, size_t len) {
  crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i)
    c = crc32_table[(c ^ static_cast<unsigned char>(buf[i])) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Writer {
  FILE* f = nullptr;
  std::string buf;
  uint32_t n_records = 0;
  uint32_t max_records = 0;
  uint64_t max_bytes = 0;

  int flush_chunk() {
    if (n_records == 0) return 0;
    uint32_t crc = crc32(buf.data(), buf.size());
    uint64_t plen = buf.size();
    if (fwrite(&kMagic, 4, 1, f) != 1) return -1;
    if (fwrite(&n_records, 4, 1, f) != 1) return -1;
    if (fwrite(&plen, 8, 1, f) != 1) return -1;
    if (fwrite(&crc, 4, 1, f) != 1) return -1;
    if (plen && fwrite(buf.data(), 1, plen, f) != plen) return -1;
    buf.clear();
    n_records = 0;
    return 0;
  }
};

struct Reader {
  FILE* f = nullptr;
  std::vector<std::string> records;  // current chunk
  size_t idx = 0;
  std::string out_hold;

  // returns 0 ok, -1 eof, -2 corrupt
  int load_chunk() {
    records.clear();
    idx = 0;
    uint32_t magic = 0, n = 0, crc = 0;
    uint64_t plen = 0;
    if (fread(&magic, 4, 1, f) != 1) return -1;
    if (magic != kMagic) return -2;
    if (fread(&n, 4, 1, f) != 1) return -2;
    if (fread(&plen, 8, 1, f) != 1) return -2;
    if (fread(&crc, 4, 1, f) != 1) return -2;
    std::string payload(plen, '\0');
    if (plen && fread(&payload[0], 1, plen, f) != plen) return -2;
    if (crc32(payload.data(), payload.size()) != crc) return -2;
    size_t off = 0;
    for (uint32_t i = 0; i < n; ++i) {
      if (off + 4 > payload.size()) return -2;
      uint32_t len;
      memcpy(&len, payload.data() + off, 4);
      off += 4;
      if (off + len > payload.size()) return -2;
      records.emplace_back(payload.data() + off, len);
      off += len;
    }
    return 0;
  }
};

}  // namespace

extern "C" {

void* rio_writer_open(const char* path, uint32_t max_records,
                      uint64_t max_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Writer* w = new Writer();
  w->f = f;
  w->max_records = max_records ? max_records : 1024;
  w->max_bytes = max_bytes ? max_bytes : (1u << 20);
  return w;
}

int rio_writer_write(void* h, const char* data, uint64_t len) {
  Writer* w = static_cast<Writer*>(h);
  uint32_t len32 = static_cast<uint32_t>(len);
  w->buf.append(reinterpret_cast<const char*>(&len32), 4);
  w->buf.append(data, len);
  w->n_records += 1;
  if (w->n_records >= w->max_records || w->buf.size() >= w->max_bytes)
    return w->flush_chunk();
  return 0;
}

int rio_writer_close(void* h) {
  Writer* w = static_cast<Writer*>(h);
  int rc = w->flush_chunk();
  fclose(w->f);
  delete w;
  return rc;
}

void* rio_reader_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  Reader* r = new Reader();
  r->f = f;
  return r;
}

// Returns record length, -1 on EOF, -2 on corruption. *out valid until the
// next call on the same reader.
int64_t rio_reader_next(void* h, const char** out) {
  Reader* r = static_cast<Reader*>(h);
  while (r->idx >= r->records.size()) {
    int rc = r->load_chunk();
    if (rc != 0) return rc;
  }
  r->out_hold = std::move(r->records[r->idx++]);
  *out = r->out_hold.data();
  return static_cast<int64_t>(r->out_hold.size());
}

void rio_reader_close(void* h) {
  Reader* r = static_cast<Reader*>(h);
  fclose(r->f);
  delete r;
}

}  // extern "C"
