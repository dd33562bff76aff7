// tpuvo native I/O: fast measurement-file parser.
//
// Native equivalent of the reference's C++ data layer
// (src/my_utilities.cpp:20-134 — tokenizer + per-line parse): a
// zero-dependency C++17 scanner that fills caller-allocated padded arrays
// (structure-of-arrays, the device upload layout) in one pass with no
// per-token heap allocation.  The port's own copy of csrc/loader.cpp,
// exposed via ctypes from tpuvo_torch/data/native.py.
//
// File format (see tpuvo_torch/data/loader.py):
//   seq: <i>
//   gt_pose: <x> <y> <theta>
//   odom_pose: <x> <y> <theta>
//   point <id_meas> <id_real> <u> <v> <d0> ... <d9>
//
// Build: none by hand — tpuvo_torch/data/native.py compiles it with the
// host C++ compiler at first use into build/tpuvo_torch/.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cctype>

namespace {

// strtof-based field scanner over a mutable buffer
struct Scanner {
  const char* p;
  const char* end;

  explicit Scanner(const char* data, size_t n) : p(data), end(data + n) {}

  bool next_float(float* out) {
    char* q = nullptr;
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    if (p >= end || *p == '\n') return false;
    *out = std::strtof(p, &q);
    if (q == p) return false;
    p = q;
    return true;
  }

  bool next_int(int* out) {
    float f;
    if (!next_float(&f)) return false;
    *out = static_cast<int>(f);
    return true;
  }

  void skip_line() {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }

  bool starts_with(const char* tok) {
    size_t n = std::strlen(tok);
    return (size_t)(end - p) >= n && std::memcmp(p, tok, n) == 0;
  }
};

}  // namespace

extern "C" {

// Parses one meas file into the caller's padded arrays.
// Returns the number of observations (>= 0) or a negative error code:
//   -1 cannot open/read file, -2 more observations than max_obs.
int tpuvo_parse_measurement(
    const char* path, int max_obs, int desc_dim,
    float* gt_pose,     // (3,)
    float* odom_pose,   // (3,)
    int* id_meas,       // (max_obs,)
    int* id_real,       // (max_obs,)
    float* uv,          // (max_obs, 2)
    float* desc         // (max_obs, desc_dim)
) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size <= 0) { std::fclose(f); return -1; }
  char* buf = static_cast<char*>(std::malloc(size));
  if (!buf || std::fread(buf, 1, size, f) != static_cast<size_t>(size)) {
    std::free(buf);
    std::fclose(f);
    return -1;
  }
  std::fclose(f);

  Scanner s(buf, size);
  int n = 0;
  int rc = 0;
  while (s.p < s.end) {
    if (s.starts_with("point ")) {
      s.p += 6;
      if (n >= max_obs) { rc = -2; break; }
      int im, ir;
      float u, v;
      if (!s.next_int(&im) || !s.next_int(&ir) ||
          !s.next_float(&u) || !s.next_float(&v)) {
        s.skip_line();
        continue;
      }
      bool ok = true;
      for (int d = 0; d < desc_dim; ++d) {
        if (!s.next_float(&desc[n * desc_dim + d])) { ok = false; break; }
      }
      if (ok) {
        id_meas[n] = im;
        id_real[n] = ir;
        uv[n * 2] = u;
        uv[n * 2 + 1] = v;
        ++n;
      }
      s.skip_line();
    } else if (s.starts_with("gt_pose:")) {
      s.p += 8;
      s.next_float(&gt_pose[0]);
      s.next_float(&gt_pose[1]);
      s.next_float(&gt_pose[2]);
      s.skip_line();
    } else if (s.starts_with("odom_pose:")) {
      s.p += 10;
      s.next_float(&odom_pose[0]);
      s.next_float(&odom_pose[1]);
      s.next_float(&odom_pose[2]);
      s.skip_line();
    } else {
      s.skip_line();
    }
  }

  std::free(buf);
  return rc < 0 ? rc : n;
}

// Parses world.dat: rows of "id x y z d0..d9"; returns row count or -1.
int tpuvo_parse_world(
    const char* path, int max_points, int desc_dim,
    int* ids, float* xyz, float* desc
) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char* buf = static_cast<char*>(std::malloc(size > 0 ? size : 1));
  if (!buf || std::fread(buf, 1, size, f) != static_cast<size_t>(size)) {
    std::free(buf);
    std::fclose(f);
    return -1;
  }
  std::fclose(f);

  Scanner s(buf, size);
  int n = 0;
  while (s.p < s.end && n < max_points) {
    int id;
    float x, y, z;
    if (s.next_int(&id) && s.next_float(&x) && s.next_float(&y) && s.next_float(&z)) {
      bool ok = true;
      for (int d = 0; d < desc_dim; ++d) {
        if (!s.next_float(&desc[n * desc_dim + d])) { ok = false; break; }
      }
      if (ok) {
        ids[n] = id;
        xyz[n * 3] = x;
        xyz[n * 3 + 1] = y;
        xyz[n * 3 + 2] = z;
        ++n;
      }
    }
    s.skip_line();
  }
  std::free(buf);
  return n;
}

}  // extern "C"
