// Native IO runtime for cudasbmp_jax.
//
// Counterpart of the reference's C++/CUDA helper layer
// (src/helper/helper.cu: readObstaclesFromCSV, copyAndWriteVectorToCSV
// templates in include/helper/helper.cuh:53-79): bulk CSV formatting/parsing
// is host-side native code, not Python. Exposed with a plain C ABI and bound
// via ctypes (no pybind11 in this image).
//
// Build: make -C native   (produces libcsbmp_io.so)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// Write a row-major [rows x cols] double matrix as CSV with %.9g formatting
// (matches the reference dump layout: `cols` comma-separated values per
// line). Returns 0 on success, nonzero errno-style code on failure.
int csbmp_write_csv(const double* data, int64_t rows, int64_t cols,
                    const char* path) {
  FILE* f = std::fopen(path, "w");
  if (!f) return 1;
  // Buffered manual formatting: ~10x faster than numpy.savetxt for the
  // 30k x 7 sample dumps.
  std::string buf;
  buf.reserve(1 << 20);
  char tmp[64];
  for (int64_t r = 0; r < rows; ++r) {
    for (int64_t c = 0; c < cols; ++c) {
      int n = std::snprintf(tmp, sizeof tmp, "%.9g", data[r * cols + c]);
      buf.append(tmp, n);
      buf.push_back(c + 1 == cols ? '\n' : ',');
    }
    if (buf.size() > (1 << 20) - 1024) {
      if (std::fwrite(buf.data(), 1, buf.size(), f) != buf.size()) {
        std::fclose(f);
        return 2;
      }
      buf.clear();
    }
  }
  int rc = 0;
  if (std::fwrite(buf.data(), 1, buf.size(), f) != buf.size()) rc = 2;
  if (std::fclose(f) != 0) rc = rc ? rc : 3;
  return rc;
}

// Parse a CSV of floats (arbitrary rows, comma-separated; blank lines
// skipped) into out (caller-allocated, capacity cap). Returns the number of
// values parsed, or -1 on open failure, -2 if the file holds more than cap
// values. The float-stream semantics match readObstaclesFromCSV
// (helper.cu:11-34), which reads every value in file order.
int64_t csbmp_read_csv(const char* path, double* out, int64_t cap) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  int64_t count = 0;
  char line[1 << 16];
  while (std::fgets(line, sizeof line, f)) {
    char* p = line;
    while (*p) {
      char* end = nullptr;
      double v = std::strtod(p, &end);
      if (end == p) {  // not a number here; advance past separator/garbage
        ++p;
        continue;
      }
      if (count >= cap) {
        std::fclose(f);
        return -2;
      }
      out[count++] = v;
      p = end;
      if (*p == ',') ++p;
    }
  }
  std::fclose(f);
  return count;
}

}  // extern "C"
