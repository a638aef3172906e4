// SCT — smartcal columnar table store (first-party native data edge).
//
// The reference's Measurement-Set I/O runs through casacore, a C++ table
// system reached via python-casacore (reference calibration/casa_io.py:1,
// generate_data.py:5-7).  This file is the framework's own native
// equivalent for the synthetic/work-file path: a single-file binary
// columnar table with named, typed, n-dimensional columns, written and
// read through a C ABI (ctypes-bound, no pybind11 in this image).
//
// Format (little-endian, version 1):
//   char   magic[4] = "SCT1"
//   u32    ncols
//   ncols x {
//     u32  name_len;  char name[name_len]
//     u32  dtype                // codes below, match numpy dtypes
//     u32  ndim                 // 0 for scalars
//     u64  dims[ndim]
//     u64  nbytes               // payload size of this column
//   }
//   column payloads, each 64-byte aligned, in header order.
//
// dtype codes: 0=float32 1=float64 2=int32 3=int64 4=complex64
//              5=complex128 6=uint8
//
// All functions return 0 (or a non-negative count) on success and a
// negative error code on failure; no exceptions cross the ABI.

#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr char kMagic[4] = {'S', 'C', 'T', '1'};
constexpr uint64_t kAlign = 64;

constexpr int kErrIO = -1;        // open/read/write failure
constexpr int kErrFormat = -2;    // bad magic / truncated header
constexpr int kErrNotFound = -3;  // no such column
constexpr int kErrSpace = -4;     // caller buffer too small
constexpr int kErrArg = -5;       // bad argument

size_t dtype_size(uint32_t code) {
  switch (code) {
    case 0: return 4;   // float32
    case 1: return 8;   // float64
    case 2: return 4;   // int32
    case 3: return 8;   // int64
    case 4: return 8;   // complex64
    case 5: return 16;  // complex128
    case 6: return 1;   // uint8
    default: return 0;
  }
}

struct ColMeta {
  std::string name;
  uint32_t dtype = 0;
  std::vector<uint64_t> dims;
  uint64_t nbytes = 0;
  uint64_t offset = 0;  // absolute file offset of the payload
};

struct FileCloser {
  FILE* f;
  ~FileCloser() { if (f) std::fclose(f); }
};

struct SctHandle {
  FILE* f = nullptr;
  std::vector<ColMeta> cols;
};

bool read_exact(FILE* f, void* p, size_t n) {
  return std::fread(p, 1, n, f) == n;
}

bool write_exact(FILE* f, const void* p, size_t n) {
  return std::fwrite(p, 1, n, f) == n;
}

// Parse the header; on success positions *f at the end of the header and
// fills cols (offsets resolved).  Returns 0 or a negative error.
int parse_header(FILE* f, std::vector<ColMeta>* cols) {
  char magic[4];
  uint32_t ncols = 0;
  if (!read_exact(f, magic, 4)) return kErrFormat;
  if (std::memcmp(magic, kMagic, 4) != 0) return kErrFormat;
  if (!read_exact(f, &ncols, 4)) return kErrFormat;
  if (ncols > 1u << 20) return kErrFormat;
  cols->clear();
  cols->reserve(ncols);
  for (uint32_t i = 0; i < ncols; ++i) {
    ColMeta c;
    uint32_t name_len = 0;
    if (!read_exact(f, &name_len, 4)) return kErrFormat;
    if (name_len > 4096) return kErrFormat;
    c.name.resize(name_len);
    if (name_len && !read_exact(f, &c.name[0], name_len)) return kErrFormat;
    uint32_t ndim = 0;
    if (!read_exact(f, &c.dtype, 4)) return kErrFormat;
    if (!read_exact(f, &ndim, 4)) return kErrFormat;
    if (ndim > 16) return kErrFormat;
    c.dims.resize(ndim);
    if (ndim && !read_exact(f, c.dims.data(), 8 * ndim)) return kErrFormat;
    if (!read_exact(f, &c.nbytes, 8)) return kErrFormat;
    cols->push_back(std::move(c));
  }
  // resolve aligned payload offsets relative to the header end
  long hdr_end = std::ftell(f);
  if (hdr_end < 0) return kErrIO;
  uint64_t off = static_cast<uint64_t>(hdr_end);
  for (auto& c : *cols) {
    off = (off + kAlign - 1) / kAlign * kAlign;
    c.offset = off;
    off += c.nbytes;
  }
  return 0;
}

}  // namespace

extern "C" {

// Write a table.  dims_flat packs each column's dims consecutively
// (sum(ndims[i]) entries).  Payload sizes are derived from dims * dtype.
int sct_write(const char* path, int ncols, const char** names,
              const int* dtypes, const int* ndims,
              const int64_t* dims_flat, const void** data) {
  if (!path || ncols < 0) return kErrArg;
  // unique temp name: concurrent writers to the same table must not
  // truncate each other's staging file (the rename stays atomic)
  static std::atomic<uint64_t> seq{0};
  std::string tmp = std::string(path) + ".tmp." +
                    std::to_string(static_cast<long>(getpid())) + "." +
                    std::to_string(seq.fetch_add(1));
  // reject anything the reader's header limits would refuse BEFORE
  // creating the staging file — a successful write must stay readable
  for (int i = 0; i < ncols; ++i) {
    if (dtype_size(static_cast<uint32_t>(dtypes[i])) == 0) return kErrArg;
    if (std::strlen(names[i]) > 4096) return kErrArg;
    if (ndims[i] < 0 || ndims[i] > 16) return kErrArg;
  }
  FILE* f = std::fopen(tmp.c_str(), "wb");
  if (!f) return kErrIO;
  FileCloser closer{f};
  struct TmpCleaner {       // unlink the staging file unless committed
    const std::string* name;
    ~TmpCleaner() { if (name) std::remove(name->c_str()); }
  } tmp_cleaner{&tmp};

  if (!write_exact(f, kMagic, 4)) return kErrIO;
  uint32_t nc = static_cast<uint32_t>(ncols);
  if (!write_exact(f, &nc, 4)) return kErrIO;

  std::vector<uint64_t> sizes(ncols);
  const int64_t* dp = dims_flat;
  for (int i = 0; i < ncols; ++i) {
    size_t esz = dtype_size(static_cast<uint32_t>(dtypes[i]));
    uint64_t n = 1;
    uint32_t name_len = static_cast<uint32_t>(std::strlen(names[i]));
    uint32_t dt = static_cast<uint32_t>(dtypes[i]);
    uint32_t nd = static_cast<uint32_t>(ndims[i]);
    if (!write_exact(f, &name_len, 4)) return kErrIO;
    if (!write_exact(f, names[i], name_len)) return kErrIO;
    if (!write_exact(f, &dt, 4)) return kErrIO;
    if (!write_exact(f, &nd, 4)) return kErrIO;
    for (int d = 0; d < ndims[i]; ++d) {
      uint64_t dim = static_cast<uint64_t>(dp[d]);
      if (!write_exact(f, &dim, 8)) return kErrIO;
      n *= dim;
    }
    dp += ndims[i];
    sizes[i] = n * esz;
    if (!write_exact(f, &sizes[i], 8)) return kErrIO;
  }

  static const char pad[kAlign] = {0};
  for (int i = 0; i < ncols; ++i) {
    long pos = std::ftell(f);
    if (pos < 0) return kErrIO;
    uint64_t aligned =
        (static_cast<uint64_t>(pos) + kAlign - 1) / kAlign * kAlign;
    if (!write_exact(f, pad, aligned - pos)) return kErrIO;
    if (sizes[i] && !write_exact(f, data[i], sizes[i])) return kErrIO;
  }
  // flush + fsync BEFORE the rename: otherwise a crash can commit the
  // rename metadata while the data blocks are still unwritten, replacing
  // a good table with a truncated one
  if (std::fflush(f) != 0) return kErrIO;
  if (fsync(fileno(f)) != 0) return kErrIO;
  std::fclose(f);
  closer.f = nullptr;
  if (std::rename(tmp.c_str(), path) != 0) return kErrIO;  // atomic replace
  tmp_cleaner.name = nullptr;                              // committed
  return 0;
}

// ---- handle-based reader: the header is parsed ONCE per open -------------

void* sct_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto* h = new SctHandle();
  h->f = f;
  if (parse_header(f, &h->cols) != 0) {
    std::fclose(f);
    delete h;
    return nullptr;
  }
  return h;
}

void sct_close(void* handle) {
  auto* h = static_cast<SctHandle*>(handle);
  if (!h) return;
  if (h->f) std::fclose(h->f);
  delete h;
}

int sct_h_ncols(void* handle) {
  return static_cast<int>(static_cast<SctHandle*>(handle)->cols.size());
}

// Index of a named column, or kErrNotFound.
int sct_h_find(void* handle, const char* name) {
  auto* h = static_cast<SctHandle*>(handle);
  for (size_t i = 0; i < h->cols.size(); ++i)
    if (h->cols[i].name == name) return static_cast<int>(i);
  return kErrNotFound;
}

// Metadata of column `index`: name copied into name_out (NUL-terminated,
// capacity name_cap), dims into dims_out (capacity 16).  Returns ndim.
int sct_h_col_meta(void* handle, int index, char* name_out, int name_cap,
                   int* dtype, int64_t* dims_out) {
  auto* h = static_cast<SctHandle*>(handle);
  if (index < 0 || index >= static_cast<int>(h->cols.size())) return kErrArg;
  const ColMeta& c = h->cols[index];
  if (static_cast<int>(c.name.size()) + 1 > name_cap) return kErrSpace;
  std::memcpy(name_out, c.name.c_str(), c.name.size() + 1);
  *dtype = static_cast<int>(c.dtype);
  for (size_t d = 0; d < c.dims.size(); ++d)
    dims_out[d] = static_cast<int64_t>(c.dims[d]);
  return static_cast<int>(c.dims.size());
}

// Read column `index` into out (capacity out_bytes).  Returns bytes read.
int64_t sct_h_read_col(void* handle, int index, void* out,
                       int64_t out_bytes) {
  auto* h = static_cast<SctHandle*>(handle);
  if (index < 0 || index >= static_cast<int>(h->cols.size())) return kErrArg;
  const ColMeta& c = h->cols[index];
  if (static_cast<int64_t>(c.nbytes) > out_bytes) return kErrSpace;
  if (std::fseek(h->f, static_cast<long>(c.offset), SEEK_SET) != 0)
    return kErrIO;
  if (c.nbytes && !read_exact(h->f, out, c.nbytes)) return kErrIO;
  return static_cast<int64_t>(c.nbytes);
}

}  // extern "C"
