// Host-side native helpers of the port's LineMOD loader, built with one
// g++ call into pose6d_tpu_torch/_build/ (pose6d_tpu_torch/data/_native.py)
// and loaded through ctypes:
//
//   parse_gt_yml / parse_info_yml / linemod_free: the parser of the LineMOD
//     dataset's restricted YAML files, a copy of the JAX package's
//     native/linemod_index.cpp (which reads the same two grammars):
//
//       gt.yml:                         info.yml:
//         <frame>:                        <frame>:
//         - cam_R_m2c: [f, ...x9]           cam_K: [f, ...x9]
//           cam_t_m2c: [f, f, f]            depth_scale: f
//           obj_bb: [i, i, i, i]
//           obj_id: i
//
//     Inline flow lists may wrap across lines. Numbers go through strtod,
//     so they are the correctly rounded doubles a YAML reader gives.
//
//   png_unfilter: undoes the five PNG row filters (None, Sub, Up, Average,
//     Paeth) of an inflated, non-interlaced image (pose6d_tpu_torch/data/png.py).
//     Average and Paeth depend on the reconstructed byte to their left, so
//     a row is a serial chain; in C it runs at memory speed.
//
// Build: g++ -O3 -shared -fPIC -o liblinemod_host.so linemod_host.cpp

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct GtAnno {
  int frame_id;
  int obj_id;
  double bbox[4];
  double R[9];
  double t[3];
};

struct InfoEntry {
  int frame_id;
  double K[9];
  double depth_scale;
};

// Read a whole file into a string; empty on failure.
std::string read_file(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return {};
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(n > 0 ? static_cast<size_t>(n) : 0, '\0');
  if (n > 0 && std::fread(&buf[0], 1, static_cast<size_t>(n), f) != static_cast<size_t>(n)) {
    std::fclose(f);
    return {};
  }
  std::fclose(f);
  return buf;
}

// Parse a bracketed flow list starting at s[i] == '['; advances i past ']'.
// Returns false on malformed input or if more than max_out values appear.
bool parse_flow_list(const std::string& s, size_t& i, double* out, int max_out,
                     int* n_out) {
  while (i < s.size() && s[i] != '[') {
    if (s[i] == '\n' && s.find('[', i) == std::string::npos) return false;
    ++i;
  }
  if (i >= s.size()) return false;
  ++i;  // past '['
  int n = 0;
  while (i < s.size() && s[i] != ']') {
    // skip separators/whitespace/newlines (lists may wrap)
    if (s[i] == ',' || s[i] == ' ' || s[i] == '\n' || s[i] == '\r' || s[i] == '\t') {
      ++i;
      continue;
    }
    char* end = nullptr;
    double v = std::strtod(s.c_str() + i, &end);
    if (end == s.c_str() + i) return false;
    if (n >= max_out) return false;
    out[n++] = v;
    i = static_cast<size_t>(end - s.c_str());
  }
  if (i >= s.size()) return false;
  ++i;  // past ']'
  *n_out = n;
  return true;
}

// At line start: parse "<int>:" returning the frame id, or -1.
int parse_frame_header(const std::string& s, size_t i, size_t line_end) {
  if (i >= s.size() || s[i] < '0' || s[i] > '9') return -1;
  char* end = nullptr;
  long v = std::strtol(s.c_str() + i, &end, 10);
  size_t j = static_cast<size_t>(end - s.c_str());
  if (j >= line_end || s[j] != ':') return -1;
  return static_cast<int>(v);
}

bool key_at(const std::string& s, size_t i, const char* key) {
  return s.compare(i, std::strlen(key), key) == 0;
}

}  // namespace

extern "C" {

// Parses gt.yml. On success returns the annotation count and fills
// *out_data with a malloc'd double array [count * 18]:
//   [frame, obj_id, bbox(4), R(9), t(3)]  per row.
// Returns -1 on failure. Caller frees with linemod_free.
long parse_gt_yml(const char* path, double** out_data) {
  std::string s = read_file(path);
  if (s.empty()) return -1;

  std::vector<GtAnno> annos;
  int cur_frame = -1;
  GtAnno cur{};
  bool have_anno = false;
  bool valid = true;

  auto flush = [&]() {
    if (have_anno) annos.push_back(cur);
    have_anno = false;
  };

  size_t i = 0;
  while (i < s.size() && valid) {
    size_t line_end = s.find('\n', i);
    if (line_end == std::string::npos) line_end = s.size();

    int fid = parse_frame_header(s, i, line_end);
    if (fid >= 0) {
      flush();
      cur_frame = fid;
      i = line_end + 1;
      continue;
    }

    size_t j = i;
    while (j < line_end && (s[j] == ' ' || s[j] == '-')) ++j;

    bool starts_item = (j > i) && (s[i] == '-' || s.compare(i, 2, "- ") == 0 ||
                                   (s[i] == ' ' && s.find("- ", i) < j));
    // a "- " at the start of the (possibly indented) line begins a new anno
    size_t dash = s.find("- ", i);
    if (dash != std::string::npos && dash < j) {
      flush();
      std::memset(&cur, 0, sizeof(cur));
      cur.frame_id = cur_frame;
      have_anno = true;
    }
    (void)starts_item;

    if (j < line_end) {
      int n = 0;
      if (key_at(s, j, "cam_R_m2c:")) {
        size_t k = j + 10;
        valid = parse_flow_list(s, k, cur.R, 9, &n) && n == 9;
        i = k;
        // advance to next newline from k
        line_end = s.find('\n', i);
        if (line_end == std::string::npos) line_end = s.size();
      } else if (key_at(s, j, "cam_t_m2c:")) {
        size_t k = j + 10;
        valid = parse_flow_list(s, k, cur.t, 3, &n) && n == 3;
        i = k;
        line_end = s.find('\n', i);
        if (line_end == std::string::npos) line_end = s.size();
      } else if (key_at(s, j, "obj_bb:")) {
        size_t k = j + 7;
        valid = parse_flow_list(s, k, cur.bbox, 4, &n) && n == 4;
        i = k;
        line_end = s.find('\n', i);
        if (line_end == std::string::npos) line_end = s.size();
      } else if (key_at(s, j, "obj_id:")) {
        cur.obj_id = std::atoi(s.c_str() + j + 7);
      }
    }
    i = line_end + 1;
  }
  flush();
  if (!valid) return -1;

  double* data = static_cast<double*>(std::malloc(annos.size() * 18 * sizeof(double)));
  if (!data) return -1;
  for (size_t k = 0; k < annos.size(); ++k) {
    double* row = data + k * 18;
    row[0] = annos[k].frame_id;
    row[1] = annos[k].obj_id;
    std::memcpy(row + 2, annos[k].bbox, 4 * sizeof(double));
    std::memcpy(row + 6, annos[k].R, 9 * sizeof(double));
    std::memcpy(row + 15, annos[k].t, 3 * sizeof(double));
  }
  *out_data = data;
  return static_cast<long>(annos.size());
}

// Parses info.yml into rows of [frame, K(9), depth_scale] (11 doubles).
long parse_info_yml(const char* path, double** out_data) {
  std::string s = read_file(path);
  if (s.empty()) return -1;

  std::vector<InfoEntry> entries;
  InfoEntry cur{};
  bool have = false;
  bool valid = true;

  size_t i = 0;
  while (i < s.size() && valid) {
    size_t line_end = s.find('\n', i);
    if (line_end == std::string::npos) line_end = s.size();

    int fid = parse_frame_header(s, i, line_end);
    if (fid >= 0) {
      if (have) entries.push_back(cur);
      std::memset(&cur, 0, sizeof(cur));
      cur.frame_id = fid;
      cur.depth_scale = 1.0;
      have = true;
      i = line_end + 1;
      continue;
    }

    size_t j = i;
    while (j < line_end && s[j] == ' ') ++j;
    if (j < line_end) {
      int n = 0;
      if (key_at(s, j, "cam_K:")) {
        size_t k = j + 6;
        valid = parse_flow_list(s, k, cur.K, 9, &n) && n == 9;
        i = k;
        line_end = s.find('\n', i);
        if (line_end == std::string::npos) line_end = s.size();
      } else if (key_at(s, j, "depth_scale:")) {
        cur.depth_scale = std::atof(s.c_str() + j + 12);
      }
    }
    i = line_end + 1;
  }
  if (have) entries.push_back(cur);
  if (!valid) return -1;

  double* data = static_cast<double*>(std::malloc(entries.size() * 11 * sizeof(double)));
  if (!data) return -1;
  for (size_t k = 0; k < entries.size(); ++k) {
    double* row = data + k * 11;
    row[0] = entries[k].frame_id;
    std::memcpy(row + 1, entries[k].K, 9 * sizeof(double));
    row[10] = entries[k].depth_scale;
  }
  *out_data = data;
  return static_cast<long>(entries.size());
}

void linemod_free(double* p) { std::free(p); }

// Reconstructs `height` rows of `stride` bytes from `src`, which holds each
// row as one filter-type byte followed by its `stride` filtered bytes (the
// inflated IDAT stream), into `dst` [height * stride]. `bpp` is the bytes per
// complete pixel (3 for 8-bit RGB, 2 for 16-bit grey): the filters' "left"
// byte is bpp bytes back, 0 before the row's first pixel; the row above the
// first is 0. Returns 0, or row + 1 of the first row whose filter type is not
// 0-4.
long png_unfilter(const unsigned char* src, unsigned char* dst, long height, long stride,
                  int bpp) {
  for (long y = 0; y < height; ++y) {
    const unsigned char* in = src + y * (stride + 1);
    const int type = in[0];
    ++in;
    unsigned char* out = dst + y * stride;
    const unsigned char* up = y > 0 ? out - stride : nullptr;
    switch (type) {
      case 0:
        std::memcpy(out, in, static_cast<size_t>(stride));
        break;
      case 1:
        for (long i = 0; i < stride; ++i)
          out[i] = static_cast<unsigned char>(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (long i = 0; i < stride; ++i)
          out[i] = static_cast<unsigned char>(in[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (long i = 0; i < stride; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          out[i] = static_cast<unsigned char>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long i = 0; i < stride; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = static_cast<unsigned char>(in[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
