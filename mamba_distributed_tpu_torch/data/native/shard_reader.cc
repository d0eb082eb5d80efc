// Native shard reader: mmap'd .npy token shards + batch assembly (a copy
// of the JAX package's data/native/shard_reader.cc).
//
// The runtime-native piece of the data pipeline (the reference's loader,
// dataloader.py:7-11, np.load()s the whole shard into host RAM and
// re-slices tensors per batch).  Here shards are memory-mapped —
// the OS pages in only the strided windows a rank actually reads, which is
// what multi-host rank striding wants — and the x/y next-token pair is
// assembled into caller-provided int32 buffers in one pass.
//
// Exposed as a plain C ABI for ctypes (no Python headers needed); built
// lazily by data/native.py with g++ -O3 -shared -fPIC.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct NpyShard {
  void* map = nullptr;       // whole file mapping
  size_t map_len = 0;
  const uint8_t* data = nullptr;  // token payload (after the npy header)
  int64_t n_tokens = 0;
  int dtype_size = 0;        // 2 (uint16) or 4 (uint32/int32)
  bool is_signed = false;
};

// Parse the .npy v1/v2 header; returns payload offset or -1.
// Header format: \x93NUMPY <maj> <min> <hlen:2 or 4> <dict padded to 64>
int64_t parse_npy_header(const uint8_t* buf, size_t len, int* dtype_size,
                         bool* is_signed, int64_t* count) {
  if (len < 10 || memcmp(buf, "\x93NUMPY", 6) != 0) return -1;
  int major = buf[6];
  size_t hlen, off;
  if (major == 1) {
    hlen = buf[8] | (buf[9] << 8);
    off = 10;
  } else {
    hlen = buf[8] | (buf[9] << 8) | (static_cast<size_t>(buf[10]) << 16) |
           (static_cast<size_t>(buf[11]) << 24);
    off = 12;
  }
  if (off + hlen > len) return -1;
  char header[4096];
  size_t n = hlen < sizeof(header) - 1 ? hlen : sizeof(header) - 1;
  memcpy(header, buf + off, n);
  header[n] = 0;

  // descr: expect little-endian or native 2/4-byte ints
  const char* descr = strstr(header, "'descr'");
  if (!descr) return -1;
  const char* q = strchr(descr + 7, '\'');
  if (!q) return -1;
  const char* type_str = q + 1;  // e.g. "<u2", "<u4", "<i4", "|u1"
  char endian = type_str[0];
  char kind = type_str[1];
  int size = atoi(type_str + 2);
  if (endian == '>') return -1;  // big-endian unsupported
  if (kind != 'u' && kind != 'i') return -1;
  if (size != 2 && size != 4) return -1;
  *dtype_size = size;
  *is_signed = (kind == 'i');

  if (strstr(header, "'fortran_order': True")) return -1;

  const char* shape = strstr(header, "'shape'");
  if (!shape) return -1;
  const char* paren = strchr(shape, '(');
  if (!paren) return -1;
  int64_t total = 1;
  const char* pc = paren + 1;
  while (*pc && *pc != ')') {
    if (*pc >= '0' && *pc <= '9') {
      total *= strtoll(pc, const_cast<char**>(&pc), 10);
    } else {
      ++pc;
    }
  }
  *count = total;
  return static_cast<int64_t>(off + hlen);
}

}  // namespace

extern "C" {

NpyShard* shard_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 16) {
    close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return nullptr;

  int dtype_size = 0;
  bool is_signed = false;
  int64_t count = 0;
  int64_t payload = parse_npy_header(static_cast<const uint8_t*>(map),
                                     st.st_size, &dtype_size, &is_signed,
                                     &count);
  if (payload < 0 ||
      payload + count * static_cast<int64_t>(dtype_size) >
          static_cast<int64_t>(st.st_size)) {
    munmap(map, st.st_size);
    return nullptr;
  }
  NpyShard* s = new NpyShard();
  s->map = map;
  s->map_len = st.st_size;
  s->data = static_cast<const uint8_t*>(map) + payload;
  s->n_tokens = count;
  s->dtype_size = dtype_size;
  s->is_signed = is_signed;
  // rank-strided access: suppress full-file readahead so each rank only
  // pages in the windows it actually reads
  madvise(map, st.st_size, MADV_RANDOM);
  return s;
}

void shard_close(NpyShard* s) {
  if (!s) return;
  munmap(s->map, s->map_len);
  delete s;
}

int64_t shard_len(const NpyShard* s) { return s ? s->n_tokens : -1; }

// Fill x = tokens[pos : pos+count], y = tokens[pos+1 : pos+count+1] as int32.
// Returns 0 on success, -1 on out-of-range.
int shard_fill_batch(const NpyShard* s, int64_t pos, int64_t count,
                     int32_t* x, int32_t* y) {
  if (!s || pos < 0 || pos + count + 1 > s->n_tokens) return -1;
  if (s->dtype_size == 2) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(s->data) + pos;
    for (int64_t i = 0; i < count; ++i) {
      x[i] = static_cast<int32_t>(p[i]);
      y[i] = static_cast<int32_t>(p[i + 1]);
    }
  } else if (s->is_signed) {
    const int32_t* p = reinterpret_cast<const int32_t*>(s->data) + pos;
    memcpy(x, p, count * sizeof(int32_t));
    memcpy(y, p + 1, count * sizeof(int32_t));
  } else {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(s->data) + pos;
    for (int64_t i = 0; i < count; ++i) {
      x[i] = static_cast<int32_t>(p[i]);
      y[i] = static_cast<int32_t>(p[i + 1]);
    }
  }
  return 0;
}

}  // extern "C"
