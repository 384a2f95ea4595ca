// Native .npz field loader — this package's answer to the reference's input
// bottleneck (SURVEY.md §3.1: the TF1 feeder threads' .npz decompression is
// the classic stall).  One C call per file: zip central-directory walk +
// raw-deflate inflate + .npy header parse + dtype convert to float32, all
// with the GIL released (ctypes releases it around foreign calls), plus a
// std::thread batch entry point that bypasses Python-level fan-out entirely.
//
// Supports the exact contract deepfluids_tpu.datagen writes (and mantaflow's
// scene dumps use): np.savez_compressed entries `<key>.npy`, little-endian
// <f4/<f8 (also <i4/<i8), C-order, compression method 8 (deflate) or 0
// (stored).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 npz_loader.cc -lz -o libnpz.so

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Buf {
  std::vector<unsigned char> data;
};

// Read entire file into memory (fields are ~100 KB – 3 MB).
static bool read_file(const char* path, Buf* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->data.resize(static_cast<size_t>(n));
  size_t got = std::fread(out->data.data(), 1, out->data.size(), f);
  std::fclose(f);
  return got == out->data.size();
}

static uint16_t rd16(const unsigned char* p) {
  return static_cast<uint16_t>(p[0] | (p[1] << 8));
}
static uint32_t rd32(const unsigned char* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

// Locate `<key>.npy` in the zip; returns the decompressed .npy bytes.
static bool extract_member(const Buf& zip, const std::string& member,
                           std::vector<unsigned char>* out) {
  const unsigned char* d = zip.data.data();
  size_t n = zip.data.size();
  if (n < 22) return false;
  // Find End Of Central Directory (no zip comment in numpy's writer, but
  // scan back defensively).
  size_t eocd = std::string::npos;
  size_t limit = n >= 22 + 65536 ? n - 22 - 65536 : 0;
  for (size_t i = n - 22; ; --i) {
    if (rd32(d + i) == 0x06054b50) { eocd = i; break; }
    if (i == limit) break;
  }
  if (eocd == std::string::npos) return false;
  uint16_t count = rd16(d + eocd + 10);
  uint32_t cd_off = rd32(d + eocd + 16);

  size_t p = cd_off;
  for (uint16_t e = 0; e < count; ++e) {
    if (p + 46 > n || rd32(d + p) != 0x02014b50) return false;
    uint16_t method = rd16(d + p + 10);
    uint32_t csize = rd32(d + p + 20);
    uint32_t usize = rd32(d + p + 24);
    uint16_t name_len = rd16(d + p + 28);
    uint16_t extra_len = rd16(d + p + 30);
    uint16_t comment_len = rd16(d + p + 32);
    uint32_t lho = rd32(d + p + 42);
    // Full entry (name + extra + comment) must lie inside the buffer
    // before the name is read — truncated/crafted central directories
    // otherwise cause a heap over-read here.
    if (p + 46 + static_cast<size_t>(name_len) + extra_len + comment_len > n)
      return false;
    std::string name(reinterpret_cast<const char*>(d + p + 46), name_len);
    p += 46 + name_len + extra_len + comment_len;
    if (name != member) continue;

    // Local header: 30 bytes + name + extra (lengths can differ from CD).
    if (lho + 30 > n || rd32(d + lho) != 0x04034b50) return false;
    uint16_t lname = rd16(d + lho + 26);
    uint16_t lextra = rd16(d + lho + 28);
    const unsigned char* payload = d + lho + 30 + lname + lextra;
    if (payload + csize > d + n) return false;

    out->resize(usize);
    if (method == 0) {  // stored
      if (csize != usize) return false;
      std::memcpy(out->data(), payload, usize);
      return true;
    }
    if (method != 8) return false;  // only deflate
    z_stream zs{};
    if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) return false;
    zs.next_in = const_cast<unsigned char*>(payload);
    zs.avail_in = csize;
    zs.next_out = out->data();
    zs.avail_out = usize;
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    return rc == Z_STREAM_END && zs.total_out == usize;
  }
  return false;
}

// Parse the .npy header; returns dtype code (4=f4, 8=f8, 14=i4, 18=i8),
// element count, and fills shape.
static bool parse_npy(const std::vector<unsigned char>& npy, int* dtype_code,
                      int64_t* shape, int* ndim, size_t* data_off) {
  if (npy.size() < 10 || std::memcmp(npy.data(), "\x93NUMPY", 6) != 0)
    return false;
  uint8_t major = npy[6];
  size_t hlen, hoff;
  if (major == 1) {
    hlen = rd16(npy.data() + 8);
    hoff = 10;
  } else {
    // v2+ header length is 4 bytes (8..11): a truncated 10-11 byte member
    // must not be read past its end.
    if (npy.size() < 12) return false;
    hlen = rd32(npy.data() + 8);
    hoff = 12;
  }
  if (hoff + hlen > npy.size()) return false;
  std::string h(reinterpret_cast<const char*>(npy.data() + hoff), hlen);
  *data_off = hoff + hlen;

  if (h.find("'fortran_order': True") != std::string::npos) return false;
  size_t dp = h.find("'descr':");
  if (dp == std::string::npos) return false;
  size_t q1 = h.find('\'', dp + 8);
  size_t q2 = h.find('\'', q1 + 1);
  std::string descr = h.substr(q1 + 1, q2 - q1 - 1);
  if (descr == "<f4") *dtype_code = 4;
  else if (descr == "<f8") *dtype_code = 8;
  else if (descr == "<i4") *dtype_code = 14;
  else if (descr == "<i8") *dtype_code = 18;
  else return false;

  size_t sp = h.find("'shape':");
  if (sp == std::string::npos) return false;
  size_t o = h.find('(', sp);
  size_t c = h.find(')', o);
  std::string dims = h.substr(o + 1, c - o - 1);
  *ndim = 0;
  const char* s = dims.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') ++s;
    if (!*s) break;
    if (*ndim >= 8) return false;  // bounds-check BEFORE the write
    shape[(*ndim)++] = std::strtoll(s, const_cast<char**>(&s), 10);
  }
  return true;
}

static int load_one(const char* path, const char* key, float* out,
                    int64_t capacity, int64_t* shape, int* ndim) {
  Buf zip;
  if (!read_file(path, &zip)) return -1;
  std::vector<unsigned char> npy;
  if (!extract_member(zip, std::string(key) + ".npy", &npy)) return -2;
  int dtype;
  size_t off;
  if (!parse_npy(npy, &dtype, shape, ndim, &off)) return -3;
  int64_t count = 1;
  for (int i = 0; i < *ndim; ++i) count *= shape[i];
  if (count > capacity) return -4;
  const unsigned char* src = npy.data() + off;
  size_t avail = npy.size() - off;
  switch (dtype) {
    case 4:
      if (avail < static_cast<size_t>(count) * 4) return -5;
      std::memcpy(out, src, count * 4);
      break;
    case 8: {
      if (avail < static_cast<size_t>(count) * 8) return -5;
      const double* s = reinterpret_cast<const double*>(src);
      for (int64_t i = 0; i < count; ++i) out[i] = static_cast<float>(s[i]);
      break;
    }
    case 14: {
      if (avail < static_cast<size_t>(count) * 4) return -5;
      const int32_t* s = reinterpret_cast<const int32_t*>(src);
      for (int64_t i = 0; i < count; ++i) out[i] = static_cast<float>(s[i]);
      break;
    }
    case 18: {
      if (avail < static_cast<size_t>(count) * 8) return -5;
      const int64_t* s = reinterpret_cast<const int64_t*>(src);
      for (int64_t i = 0; i < count; ++i) out[i] = static_cast<float>(s[i]);
      break;
    }
    default:
      return -3;
  }
  return 0;
}

}  // namespace

extern "C" {

// Read `<key>.npy` from an .npz as float32.  Returns 0 on success; fills
// shape (max 8 dims) and ndim.  Negative codes: -1 io, -2 member missing,
// -3 unsupported npy, -4 capacity, -5 truncated.
int df_npz_read(const char* path, const char* key, float* out,
                int64_t capacity, int64_t* shape, int* ndim) {
  return load_one(path, key, out, capacity, shape, ndim);
}

// Batched parallel read: n files, each into out + i*stride (stride floats).
// Every member must hold EXACTLY stride elements (the dataset contract) —
// a smaller file would otherwise part-fill its row and leave uninitialized
// memory in the output.  Returns 0 on success, the first non-zero per-file
// status, or -6 for an element-count mismatch.
int df_npz_read_batch(const char** paths, int n, const char* key, float* out,
                      int64_t stride, int64_t* shape, int* ndim,
                      int num_threads) {
  if (n <= 0) return 0;
  if (num_threads < 1) num_threads = 1;
  if (num_threads > n) num_threads = n;
  std::vector<int> status(n, 0);
  std::vector<int64_t> shapes(static_cast<size_t>(n) * 8);
  std::vector<int> ndims(n, 0);
  std::vector<std::thread> pool;
  for (int t = 0; t < num_threads; ++t) {
    pool.emplace_back([&, t]() {
      for (int i = t; i < n; i += num_threads) {
        const int64_t* sh = shapes.data() + static_cast<size_t>(i) * 8;
        status[i] = load_one(paths[i], key, out + i * stride, stride,
                             shapes.data() + static_cast<size_t>(i) * 8,
                             &ndims[i]);
        if (status[i] == 0) {
          int64_t count = 1;
          for (int d = 0; d < ndims[i]; ++d) count *= sh[d];
          if (count != stride) status[i] = -6;
        }
      }
    });
  }
  for (auto& th : pool) th.join();
  for (int i = 0; i < n; ++i) {
    if (status[i] != 0) return status[i];
  }
  *ndim = ndims[0];
  for (int i = 0; i < ndims[0]; ++i) shape[i] = shapes[i];
  return 0;
}

}  // extern "C"
