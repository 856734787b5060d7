// lrr_native — native IO runtime of lrr_tpu_torch (the port's own copy of
// lrr_tpu/io/native/lrr_native.cpp).
//
// The reference's runtime layer is C++ (ITK readers, file-based stage
// pipeline; features/ExtractFeatures.cxx:88-172, README.md:18).  This
// library provides the equivalent native components around the PyTorch
// compute path:
//   * MetaImage (.mhd/.mha) header parse + raw/zlib payload read
//   * base64 + zlib decode for VTK XML polydata arrays
//   * a threaded prefetching volume loader (producer/consumer queue) so
//     host IO and decompression overlap device compute — the "data loader"
//     role of the framework.
//
// Exposed as a plain C ABI consumed via ctypes (lrr_tpu_torch/io/native_loader.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fstream>
#include <map>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// MetaImage reading
// ---------------------------------------------------------------------------

struct MhdInfo {
  int32_t dims[3];        // x, y, z
  double spacing[3];
  double origin[3];
  int32_t element_type;   // 0=i8 1=u8 2=i16 3=u16 4=i32 5=u32 6=f32 7=f64
  int32_t compressed;
  int64_t data_offset;    // offset of payload for LOCAL .mha, else -1
  char data_file[512];
};

static int element_type_code(const std::string& met) {
  if (met == "MET_CHAR") return 0;
  if (met == "MET_UCHAR") return 1;
  if (met == "MET_SHORT") return 2;
  if (met == "MET_USHORT") return 3;
  if (met == "MET_INT") return 4;
  if (met == "MET_UINT") return 5;
  if (met == "MET_FLOAT") return 6;
  if (met == "MET_DOUBLE") return 7;
  return -1;
}

static size_t element_size(int code) {
  switch (code) {
    case 0: case 1: return 1;
    case 2: case 3: return 2;
    case 4: case 5: case 6: return 4;
    case 7: return 8;
  }
  return 0;
}

int lrr_mhd_parse_header(const char* path, MhdInfo* info) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return -1;
  std::memset(info, 0, sizeof(MhdInfo));
  info->data_offset = -1;
  info->spacing[0] = info->spacing[1] = info->spacing[2] = 1.0;

  std::string line;
  while (std::getline(f, line)) {
    auto eq = line.find('=');
    if (eq == std::string::npos) continue;
    std::string key = line.substr(0, eq);
    std::string val = line.substr(eq + 1);
    auto trim = [](std::string& s) {
      s.erase(0, s.find_first_not_of(" \t\r\n"));
      auto e = s.find_last_not_of(" \t\r\n");
      if (e != std::string::npos) s.erase(e + 1);
    };
    trim(key);
    trim(val);
    if (key == "DimSize") {
      std::istringstream ss(val);
      ss >> info->dims[0] >> info->dims[1] >> info->dims[2];
    } else if (key == "ElementSpacing" || key == "ElementSize") {
      std::istringstream ss(val);
      ss >> info->spacing[0] >> info->spacing[1] >> info->spacing[2];
    } else if (key == "Offset" || key == "Origin" || key == "Position") {
      std::istringstream ss(val);
      ss >> info->origin[0] >> info->origin[1] >> info->origin[2];
    } else if (key == "ElementType") {
      info->element_type = element_type_code(val);
    } else if (key == "CompressedData") {
      info->compressed = (val == "True" || val == "true") ? 1 : 0;
    } else if (key == "ElementDataFile") {
      if (val == "LOCAL") {
        info->data_offset = (int64_t)f.tellg();
        std::strncpy(info->data_file, "LOCAL", sizeof(info->data_file) - 1);
      } else {
        std::strncpy(info->data_file, val.c_str(), sizeof(info->data_file) - 1);
      }
      break;  // payload (or separate file) follows
    }
  }
  if (info->element_type < 0 || info->dims[0] <= 0) return -2;
  return 0;
}

// Reads payload into out (caller-allocated, nbytes =
// prod(dims)*element_size).  Returns 0 on success.
int lrr_mhd_read_data(const char* path, const MhdInfo* info, void* out,
                      int64_t nbytes) {
  std::string data_path(path);
  int64_t offset = 0;
  if (std::strcmp(info->data_file, "LOCAL") == 0) {
    offset = info->data_offset;
  } else {
    auto slash = data_path.find_last_of('/');
    std::string dir =
        (slash == std::string::npos) ? "" : data_path.substr(0, slash + 1);
    data_path = dir + info->data_file;
  }
  std::ifstream f(data_path, std::ios::binary);
  if (!f) return -1;
  f.seekg(0, std::ios::end);
  int64_t fsize = (int64_t)f.tellg() - offset;
  f.seekg(offset, std::ios::beg);

  if (!info->compressed) {
    if (fsize < nbytes) return -2;
    f.read((char*)out, nbytes);
    return f ? 0 : -3;
  }
  std::vector<char> comp(fsize);
  f.read(comp.data(), fsize);
  uLongf dest_len = (uLongf)nbytes;
  int rc = uncompress((Bytef*)out, &dest_len, (const Bytef*)comp.data(),
                      (uLong)fsize);
  return (rc == Z_OK && (int64_t)dest_len == nbytes) ? 0 : -4;
}

// ---------------------------------------------------------------------------
// base64 + zlib (VTK XML payloads)
// ---------------------------------------------------------------------------

static const int8_t B64[256] = {
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, 62, -1, -1, -1, 63, 52, 53, 54, 55, 56, 57,
    58, 59, 60, 61, -1, -1, -1, -2, -1, -1, -1, 0,  1,  2,  3,  4,  5,  6,
    7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
    25, -1, -1, -1, -1, -1, -1, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
    37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
    -1, -1, -1, -1};

// Decodes base64 text (whitespace tolerated) into out; returns decoded size
// or -1.
int64_t lrr_b64_decode(const char* text, int64_t text_len, uint8_t* out,
                       int64_t out_cap) {
  int64_t o = 0;
  uint32_t acc = 0;
  int nbits = 0;
  for (int64_t i = 0; i < text_len; ++i) {
    int8_t v = B64[(uint8_t)text[i]];
    if (v == -2) break;  // padding
    if (v < 0) continue; // whitespace
    acc = (acc << 6) | (uint32_t)v;
    nbits += 6;
    if (nbits >= 8) {
      nbits -= 8;
      if (o >= out_cap) return -1;
      out[o++] = (uint8_t)((acc >> nbits) & 0xFF);
    }
  }
  return o;
}

int64_t lrr_zlib_inflate(const uint8_t* src, int64_t src_len, uint8_t* dst,
                         int64_t dst_cap) {
  uLongf dest_len = (uLongf)dst_cap;
  int rc = uncompress((Bytef*)dst, &dest_len, (const Bytef*)src, (uLong)src_len);
  return rc == Z_OK ? (int64_t)dest_len : -1;
}

// ---------------------------------------------------------------------------
// Threaded prefetching volume loader
// ---------------------------------------------------------------------------

struct LoadedVolume {
  MhdInfo info;
  std::vector<uint8_t> data;
  int status;  // 0 ok
  int64_t index;
};

struct Loader {
  std::vector<std::string> paths;
  std::deque<LoadedVolume*> ready;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_space;
  std::atomic<int64_t> next_index{0};
  int64_t emitted = 0;
  size_t max_queue;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::map<int64_t, LoadedVolume*> out_of_order;

  ~Loader() {
    stop = true;
    cv_space.notify_all();
    for (auto& t : workers) t.join();
    for (auto* v : ready) delete v;
    for (auto& kv : out_of_order) delete kv.second;
  }
};

static void worker_main(Loader* L) {
  while (!L->stop) {
    // back-pressure BEFORE claiming work: out_of_order is then bounded by
    // the thread count, so the worker holding the next-to-emit index can
    // never be blocked behind later indices (which would deadlock the
    // in-order delivery)
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_space.wait(
          lk, [&] { return L->stop || L->ready.size() < L->max_queue; });
      if (L->stop) return;
    }
    int64_t idx = L->next_index.fetch_add(1);
    if (idx >= (int64_t)L->paths.size()) return;
    auto* v = new LoadedVolume();
    v->index = idx;
    v->status = lrr_mhd_parse_header(L->paths[idx].c_str(), &v->info);
    if (v->status == 0) {
      int64_t n = (int64_t)v->info.dims[0] * v->info.dims[1] *
                  v->info.dims[2] * (int64_t)element_size(v->info.element_type);
      v->data.resize(n);
      v->status =
          lrr_mhd_read_data(L->paths[idx].c_str(), &v->info, v->data.data(), n);
    }
    std::unique_lock<std::mutex> lk(L->mu);
    if (L->stop) {
      delete v;
      return;
    }
    // deliver strictly in order
    L->out_of_order[idx] = v;
    while (!L->out_of_order.empty() &&
           L->out_of_order.begin()->first == L->emitted) {
      L->ready.push_back(L->out_of_order.begin()->second);
      L->out_of_order.erase(L->out_of_order.begin());
      ++L->emitted;
    }
    L->cv_ready.notify_all();
  }
}

void* lrr_loader_create(const char** paths, int64_t n_paths, int n_threads,
                        int max_queue) {
  auto* L = new Loader();
  for (int64_t i = 0; i < n_paths; ++i) L->paths.emplace_back(paths[i]);
  L->max_queue = (size_t)(max_queue > 0 ? max_queue : 4);
  int nt = n_threads > 0 ? n_threads : 2;
  for (int t = 0; t < nt; ++t) L->workers.emplace_back(worker_main, L);
  return L;
}

// Blocks for the next volume (in submission order).  Returns 0 and fills
// info; caller then calls lrr_loader_copy with a big-enough buffer.
// Returns 1 when exhausted, <0 on error of that item (which stays at the
// front until lrr_loader_skip drops it).
int lrr_loader_next_info(void* handle, MhdInfo* info) {
  auto* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] {
    return !L->ready.empty() || L->emitted >= (int64_t)L->paths.size();
  });
  if (L->ready.empty()) return 1;
  auto* v = L->ready.front();
  *info = v->info;
  return v->status;
}

int64_t lrr_loader_copy(void* handle, void* out, int64_t cap) {
  auto* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->ready.empty()) return -1;
  auto* v = L->ready.front();
  if ((int64_t)v->data.size() > cap) return -2;
  std::memcpy(out, v->data.data(), v->data.size());
  int64_t n = (int64_t)v->data.size();
  L->ready.pop_front();
  delete v;
  L->cv_space.notify_all();
  return n;
}

// Drops the front volume without copying it: the caller's way past an item
// whose lrr_loader_next_info reported an error, so the items behind it are
// still delivered.
void lrr_loader_skip(void* handle) {
  auto* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->ready.empty()) return;
  delete L->ready.front();
  L->ready.pop_front();
  L->cv_space.notify_all();
}

void lrr_loader_destroy(void* handle) { delete (Loader*)handle; }

}  // extern "C"
