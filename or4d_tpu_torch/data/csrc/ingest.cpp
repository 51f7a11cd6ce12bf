// Host ingest library of the PyTorch port: PCD v0.7 reading (ascii, binary
// and binary_compressed), LZF decompression, voxel selection with the
// reference's voxel-size sweep, and the union crop of a relation with its
// subject/object mask channel.
//
// Plain C interface, loaded with ctypes by or4d_tpu_torch/data/ingest_lib.py,
// which builds it at first use with the host compiler:
//
//   $CXX -O3 -std=c++17 -fPIC -shared -ffp-contract=off
//
// Every result is bit-equal to the port's numpy and Python plain versions
// (data/pcd_io.py read_pcd_plain and lzf_decompress, data/prep.py
// voxel_downsample_indices, downsample_sweep_plain and crop_union_plain).
// The voxel coordinates are float arithmetic in the points' own precision,
// rounded op by op as numpy rounds them: no FMA contraction, no fast-math.
//
// Return values: a count >= 0, or a negative error code (see below); the PCD
// reader also writes a message into the caller's buffer.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <map>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// LZF (liblzf's format, as PCL's binary_compressed bodies hold it)
// ---------------------------------------------------------------------------

constexpr int64_t kLzfLiteralPastEnd = -1;
constexpr int64_t kLzfEndsInReference = -2;
constexpr int64_t kLzfReferenceOutOfRange = -3;

// Control byte < 32: a literal run of ctrl + 1 bytes. Otherwise a back
// reference of (ctrl >> 5) + 2 bytes (7 in the top bits takes one more
// length byte) at offset ((ctrl & 31) << 8 | next byte) + 1 behind the
// output; it may overlap what it writes. Returns the decoded size.
int64_t lzf_decompress(const uint8_t* in, int64_t in_len, uint8_t* out, int64_t out_len) {
  int64_t ip = 0, op = 0;
  while (ip < in_len) {
    const int64_t ctrl = in[ip++];
    if (ctrl < 32) {
      const int64_t n = ctrl + 1;
      if (op + n > out_len || ip + n > in_len) return kLzfLiteralPastEnd;
      std::memcpy(out + op, in + ip, static_cast<size_t>(n));
      ip += n;
      op += n;
    } else {
      int64_t n = ctrl >> 5;
      if (n == 7) {
        if (ip >= in_len) return kLzfEndsInReference;
        n += in[ip++];
      }
      if (ip >= in_len) return kLzfEndsInReference;
      const int64_t ref = op - ((ctrl & 0x1F) << 8) - 1 - in[ip++];
      n += 2;
      if (ref < 0 || op + n > out_len) return kLzfReferenceOutOfRange;
      for (int64_t k = 0; k < n; ++k) out[op + k] = out[ref + k];  // byte by byte: may overlap
      op += n;
    }
  }
  return op;
}

// ---------------------------------------------------------------------------
// Voxel selection: the up-to-max_per lowest-index points of each voxel
// ---------------------------------------------------------------------------

constexpr int64_t kNonFinite = -1;
constexpr int64_t kGridTooLarge = -2;

template <typename T>
int64_t bounds(const T* xyz, int64_t n, int64_t stride, T lo[3], T hi[3]) {
  for (int d = 0; d < 3; ++d) lo[d] = hi[d] = xyz[d];
  for (int64_t i = 0; i < n; ++i) {
    const T* p = xyz + i * stride;
    for (int d = 0; d < 3; ++d) {
      if (!std::isfinite(p[d])) return kNonFinite;
      if (p[d] < lo[d]) lo[d] = p[d];
      if (p[d] > hi[d]) hi[d] = p[d];
    }
  }
  return 0;
}

// dims = floor((max - min) / size) + 1 per axis, as numpy's vox.max(0) + 1
// (floor and the rounded division are monotonic); the mixed-radix key
// (vx * d1 + vy) * d2 + vz must fit in 64 bits.
template <typename T>
int64_t grid_dims(const T lo[3], const T hi[3], T size, uint64_t dims[3]) {
  for (int d = 0; d < 3; ++d) {
    const T q = std::floor((hi[d] - lo[d]) / size);
    if (!(q >= T(0) && q < T(18446744073709551616.0))) return kGridTooLarge;
    dims[d] = static_cast<uint64_t>(q) + 1;  // q < 2^64 - 2^11 in either precision: no wrap
  }
  const unsigned __int128 two64 = static_cast<unsigned __int128>(1) << 64;
  unsigned __int128 total = static_cast<unsigned __int128>(dims[0]) * dims[1];
  if (total > two64) return kGridTooLarge;
  total *= dims[2];
  if (total > two64) return kGridTooLarge;
  return 0;
}

// An open-addressing table of voxel keys and their counts, reused across
// the sweep's sizes: a slot belongs to the current pass when its stamp is.
class VoxelTable {
 public:
  explicit VoxelTable(int64_t n) {
    size_t cap = 64;
    while (cap < static_cast<size_t>(2 * n)) cap <<= 1;
    keys_.resize(cap);
    counts_.resize(cap);
    stamps_.assign(cap, 0);
    mask_ = cap - 1;
    shift_ = 64;
    for (size_t c = cap; c > 1; c >>= 1) --shift_;
  }

  void next_pass() {
    if (++stamp_ == 0) {  // wrapped: every slot is stale again
      std::fill(stamps_.begin(), stamps_.end(), 0);
      stamp_ = 1;
    }
  }

  // The count of ``key`` so far in this pass (a new key starts at 0).
  uint32_t& count(uint64_t key) {
    size_t s = static_cast<size_t>((key * 0x9E3779B97F4A7C15ull) >> shift_);
    while (stamps_[s] == stamp_) {
      if (keys_[s] == key) return counts_[s];
      s = (s + 1) & mask_;
    }
    stamps_[s] = stamp_;
    keys_[s] = key;
    counts_[s] = 0;
    return counts_[s];
  }

 private:
  std::vector<uint64_t> keys_;
  std::vector<uint32_t> counts_;
  std::vector<uint32_t> stamps_;
  uint32_t stamp_ = 0;
  size_t mask_ = 0;
  int shift_ = 64;
};

// Indices of the up-to-max_per lowest-index points of each occupied voxel,
// ascending (the points are visited in index order). Returns their count.
template <typename T>
int64_t select_voxels(const T* xyz, int64_t n, int64_t stride, const T lo[3], const uint64_t dims[3], T size,
                      int max_per, VoxelTable& table, int64_t* out) {
  table.next_pass();
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    const T* p = xyz + i * stride;
    const uint64_t vx = static_cast<uint64_t>(std::floor((p[0] - lo[0]) / size));
    const uint64_t vy = static_cast<uint64_t>(std::floor((p[1] - lo[1]) / size));
    const uint64_t vz = static_cast<uint64_t>(std::floor((p[2] - lo[2]) / size));
    uint32_t& c = table.count((vx * dims[1] + vy) * dims[2] + vz);
    if (c < static_cast<uint32_t>(max_per)) {
      ++c;
      out[k++] = i;
    }
  }
  return k;
}

template <typename T>
int64_t voxel_select(const T* xyz, int64_t n, int64_t stride, double size, int32_t max_per, int64_t* out) {
  if (n <= 0) return 0;
  T lo[3], hi[3];
  uint64_t dims[3];
  const T s = static_cast<T>(size);
  if (int64_t err = bounds(xyz, n, stride, lo, hi)) return err;
  if (int64_t err = grid_dims(lo, hi, s, dims)) return err;
  VoxelTable table(n);
  return select_voxels(xyz, n, stride, lo, dims, s, max_per, table, out);
}

// The reference's sweep: coarsen the voxel size through ``sizes`` until at
// most ``target`` points remain and keep the last selection above target
// (all points when the first is not above it). Returns its length.
template <typename T>
int64_t voxel_sweep(const T* xyz, int64_t n, int64_t stride, int64_t target, const double* sizes, int32_t n_sizes,
                    int32_t max_per, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  if (n <= 0) return 0;
  T lo[3], hi[3];
  if (int64_t err = bounds(xyz, n, stride, lo, hi)) return err;
  VoxelTable table(n);
  std::vector<int64_t> buf(static_cast<size_t>(n));
  int64_t best = n;
  for (int32_t j = 0; j < n_sizes; ++j) {
    uint64_t dims[3];
    const T s = static_cast<T>(sizes[j]);
    if (int64_t err = grid_dims(lo, hi, s, dims)) return err;
    const int64_t k = select_voxels(xyz, n, stride, lo, dims, s, max_per, table, buf.data());
    if (k <= target) break;
    std::memcpy(out, buf.data(), static_cast<size_t>(k) * sizeof(int64_t));
    best = k;
  }
  return best;
}

// ---------------------------------------------------------------------------
// Union crop: points strictly inside (mn, mx) on all three axes, with the
// mask 1 for the subject's label, 2 for the object's and 0 otherwise
// ---------------------------------------------------------------------------

template <typename T>
int64_t crop_union(const T* xyz, int64_t n, int64_t stride, const int32_t* labels, const T* mn, const T* mx,
                   int32_t sub, int32_t obj, int64_t* out_idx, float* out_mask) {
  int64_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    const T* p = xyz + i * stride;
    if (p[0] > mn[0] && p[0] < mx[0] && p[1] > mn[1] && p[1] < mx[1] && p[2] > mn[2] && p[2] < mx[2]) {
      out_idx[k] = i;
      out_mask[k] = labels[i] == sub ? 1.0f : labels[i] == obj ? 2.0f : 0.0f;
      ++k;
    }
  }
  return k;
}

// ---------------------------------------------------------------------------
// PCD v0.7
// ---------------------------------------------------------------------------

struct PcdError {
  std::string what;
};

struct Field {
  std::string name;
  char type;
  int size;
  int count;
};

struct Header {
  std::vector<Field> fields;
  int64_t n = 0;
  std::string mode;
  size_t body = 0;  // offset of the body in the file
};

// Python's str.split() whitespace within ASCII
bool is_space(uint8_t c) { return c == ' ' || (c >= '\t' && c <= '\r') || (c >= 0x1C && c <= 0x1F); }

std::vector<std::string> split(const uint8_t* a, const uint8_t* b) {
  std::vector<std::string> out;
  while (a < b) {
    while (a < b && is_space(*a)) ++a;
    const uint8_t* s = a;
    while (a < b && !is_space(*a)) ++a;
    if (a > s) out.emplace_back(reinterpret_cast<const char*>(s), static_cast<size_t>(a - s));
  }
  return out;
}

int64_t parse_int(const std::string& s, const char* key) {
  size_t i = (s[0] == '+' || s[0] == '-') ? 1 : 0;
  if (i == s.size() || s.size() > 18) throw PcdError{std::string("bad ") + key + " value '" + s + "'"};
  for (size_t j = i; j < s.size(); ++j)
    if (s[j] < '0' || s[j] > '9') throw PcdError{std::string("bad ") + key + " value '" + s + "'"};
  return std::strtoll(s.c_str(), nullptr, 10);
}

bool known_type(char t, int size) {
  switch (t) {
    case 'F': return size == 4 || size == 8;
    case 'U': return size == 1 || size == 2 || size == 4;
    case 'I': return size == 1 || size == 2 || size == 4;
    default: return false;
  }
}

Header parse_header(const uint8_t* buf, size_t len) {
  std::map<std::string, std::vector<std::string>> kv;
  size_t pos = 0;
  for (;;) {
    if (pos >= len) throw PcdError{"unexpected EOF in header"};
    const uint8_t* nl = static_cast<const uint8_t*>(std::memchr(buf + pos, '\n', len - pos));
    const size_t end = nl ? static_cast<size_t>(nl - buf) : len;
    std::vector<std::string> tok = split(buf + pos, buf + end);
    pos = nl ? end + 1 : len;
    if (tok.empty() || tok[0][0] == '#') continue;
    const std::string key = tok[0];
    tok.erase(tok.begin());
    kv[key] = tok;
    if (key == "DATA") break;
  }
  for (const char* key : {"FIELDS", "SIZE", "TYPE", "POINTS", "DATA"})
    if (!kv.count(key) || kv[key].empty()) throw PcdError{std::string("header has no ") + key};
  const auto& names = kv["FIELDS"];
  const auto& sizes = kv["SIZE"];
  const auto& types = kv["TYPE"];
  std::vector<std::string> counts = kv.count("COUNT") ? kv["COUNT"] : std::vector<std::string>(names.size(), "1");
  if (sizes.size() != names.size() || types.size() != names.size() || counts.size() != names.size())
    throw PcdError{"FIELDS, SIZE, TYPE and COUNT differ in length"};
  Header h;
  for (size_t i = 0; i < names.size(); ++i) {
    for (size_t j = 0; j < i; ++j)
      if (names[j] == names[i]) throw PcdError{"field '" + names[i] + "' occurs more than once"};
    Field f{names[i], types[i][0], static_cast<int>(parse_int(sizes[i], "SIZE")),
            static_cast<int>(parse_int(counts[i], "COUNT"))};
    if (types[i].size() != 1 || !known_type(f.type, f.size))
      throw PcdError{"unsupported field type " + types[i] + " of size " + sizes[i]};
    if (f.count < 1) throw PcdError{"bad COUNT of field '" + f.name + "'"};
    h.fields.push_back(f);
  }
  h.n = parse_int(kv["POINTS"][0], "POINTS");
  if (h.n < 0) throw PcdError{"negative POINTS"};
  h.mode = kv["DATA"][0];
  h.body = pos;
  return h;
}

// One field's values, point by point: at base + i * step.
struct Column {
  const uint8_t* base;
  int64_t step;
  char type;
  int size;
};

double value_at(const Column& c, int64_t i) {
  const uint8_t* p = c.base + i * c.step;
  switch (c.type) {
    case 'F':
      if (c.size == 4) {
        float v;
        std::memcpy(&v, p, 4);
        return v;
      } else {
        double v;
        std::memcpy(&v, p, 8);
        return v;
      }
    case 'U':
      if (c.size == 1) return *p;
      if (c.size == 2) {
        uint16_t v;
        std::memcpy(&v, p, 2);
        return v;
      } else {
        uint32_t v;
        std::memcpy(&v, p, 4);
        return v;
      }
    default:
      if (c.size == 1) return static_cast<int8_t>(*p);
      if (c.size == 2) {
        int16_t v;
        std::memcpy(&v, p, 2);
        return v;
      } else {
        int32_t v;
        std::memcpy(&v, p, 4);
        return v;
      }
  }
}

// The field's value as float32 bits (numpy's asarray(field, float32).view(uint32)).
uint32_t float_bits_at(const Column& c, int64_t i) {
  uint32_t bits;
  if (c.type == 'F' && c.size == 4) {
    std::memcpy(&bits, c.base + i * c.step, 4);  // as stored, NaN payloads included
  } else {
    const float v = static_cast<float>(value_at(c, i));
    std::memcpy(&bits, &v, 4);
  }
  return bits;
}

int find_field(const Header& h, const char* name) {
  for (size_t i = 0; i < h.fields.size(); ++i)
    if (h.fields[i].name == name) return static_cast<int>(i);
  return -1;
}

// x/y/z and the colour (packed rgb/rgba, else separate r/g/b) into out
// (n, 6) float32, rgb in 0..1 divided in float32; rgb 0 without a colour.
void extract(const Header& h, const std::vector<Column>& cols, float* out) {
  const int64_t n = h.n;
  auto used = [&](int f) {
    if (h.fields[f].count != 1) throw PcdError{"field '" + h.fields[f].name + "' has COUNT > 1"};
    return cols[f];
  };
  for (int d = 0; d < 3; ++d) {
    const char name[2] = {static_cast<char>('x' + d), 0};
    const int f = find_field(h, name);
    if (f < 0) throw PcdError{std::string("no field ") + name};
    const Column c = used(f);
    for (int64_t i = 0; i < n; ++i) out[i * 6 + d] = static_cast<float>(value_at(c, i));
  }
  int rgb = find_field(h, "rgb");
  if (rgb < 0) rgb = find_field(h, "rgba");
  const int r = find_field(h, "r"), g = find_field(h, "g"), b = find_field(h, "b");
  if (rgb >= 0) {
    const Column c = used(rgb);
    for (int64_t i = 0; i < n; ++i) {
      const uint32_t packed = float_bits_at(c, i);
      out[i * 6 + 3] = static_cast<float>((packed >> 16) & 0xFF) / 255.0f;
      out[i * 6 + 4] = static_cast<float>((packed >> 8) & 0xFF) / 255.0f;
      out[i * 6 + 5] = static_cast<float>(packed & 0xFF) / 255.0f;
    }
  } else if (r >= 0 && g >= 0 && b >= 0) {
    const int rgb3[3] = {r, g, b};
    for (int k = 0; k < 3; ++k) {
      const Column c = used(rgb3[k]);
      for (int64_t i = 0; i < n; ++i) out[i * 6 + 3 + k] = static_cast<float>(value_at(c, i)) / 255.0f;
    }
  } else {
    for (int64_t i = 0; i < n; ++i) out[i * 6 + 3] = out[i * 6 + 4] = out[i * 6 + 5] = 0.0f;
  }
}

// A float64 parsed from ascii, cast to the field's type as numpy's astype
// casts it (integers through a truncating int64 conversion, as x86 does),
// stored in that type's bytes.
void store_cast(double v, const Field& f, uint8_t* dst) {
  if (f.type == 'F') {
    if (f.size == 4) {
      const float x = static_cast<float>(v);
      std::memcpy(dst, &x, 4);
    } else {
      std::memcpy(dst, &v, 8);
    }
    return;
  }
  const int64_t t = (std::isfinite(v) && std::fabs(v) < 9223372036854775808.0) ? static_cast<int64_t>(v) : INT64_MIN;
  const uint64_t u = static_cast<uint64_t>(t);
  std::memcpy(dst, &u, static_cast<size_t>(f.size));  // the low bytes (little-endian)
}

// np.loadtxt(f, max_rows=n, ndmin=2): the first n rows of data (blank and
// comment lines skipped, text after '#' ignored), every row as many columns.
std::vector<uint8_t> parse_ascii(const Header& h, const uint8_t* buf, size_t len, std::vector<Column>& cols) {
  for (const Field& f : h.fields)
    if (f.count != 1) throw PcdError{"ascii PCD with COUNT > 1 is not supported"};
  const size_t nf = h.fields.size();
  std::vector<int64_t> offset(nf);
  int64_t row_bytes = 0;
  for (size_t j = 0; j < nf; ++j) {
    offset[j] = row_bytes;
    row_bytes += h.fields[j].size;
  }
  std::vector<uint8_t> rec(static_cast<size_t>(row_bytes * h.n));
  size_t pos = h.body, width = 0;
  int64_t row = 0;
  std::string tok;
  while (row < h.n) {
    if (pos >= len) throw PcdError{"ascii body ends after " + std::to_string(row) + " rows"};
    const uint8_t* nl = static_cast<const uint8_t*>(std::memchr(buf + pos, '\n', len - pos));
    size_t end = nl ? static_cast<size_t>(nl - buf) : len;
    const size_t next = nl ? end + 1 : len;
    const uint8_t* hash = static_cast<const uint8_t*>(std::memchr(buf + pos, '#', end - pos));
    if (hash) end = static_cast<size_t>(hash - buf);
    const std::vector<std::string> vals = split(buf + pos, buf + end);
    pos = next;
    if (vals.empty()) continue;
    if (width == 0) width = vals.size();
    if (vals.size() != width || width < nf)
      throw PcdError{"ascii row " + std::to_string(row) + " has " + std::to_string(vals.size()) + " columns"};
    for (size_t j = 0; j < nf; ++j) {
      const std::string& s = vals[j];
      char* stop = nullptr;
      const double v = std::strtod(s.c_str(), &stop);
      if (stop != s.c_str() + s.size() || s.find_first_of("xX") != std::string::npos)
        throw PcdError{"bad ascii value '" + s + "'"};
      store_cast(v, h.fields[j], rec.data() + row * row_bytes + offset[j]);
    }
    ++row;
  }
  cols.clear();
  for (size_t j = 0; j < nf; ++j) cols.push_back({rec.data() + offset[j], row_bytes, h.fields[j].type, h.fields[j].size});
  return rec;
}

int64_t read_pcd(const uint8_t* buf, size_t len, float* out, int64_t cap) {
  const Header h = parse_header(buf, len);
  if (h.n > cap) throw PcdError{"output holds fewer rows than POINTS"};
  std::vector<Column> cols;
  std::vector<uint8_t> storage;
  const uint8_t* body = buf + h.body;
  const size_t avail = len - h.body;
  if (h.mode == "ascii") {
    storage = parse_ascii(h, buf, len, cols);
  } else if (h.mode == "binary") {
    int64_t item = 0;
    for (const Field& f : h.fields) item += static_cast<int64_t>(f.size) * f.count;
    if (static_cast<unsigned __int128>(item) * static_cast<uint64_t>(h.n) > avail)
      throw PcdError{"truncated binary body"};
    int64_t off = 0;
    for (const Field& f : h.fields) {
      cols.push_back({body + off, item, f.type, f.size});
      off += static_cast<int64_t>(f.size) * f.count;
    }
  } else if (h.mode == "binary_compressed") {
    if (avail < 8) throw PcdError{"truncated binary_compressed header"};
    uint32_t comp, raw;
    std::memcpy(&comp, body, 4);
    std::memcpy(&raw, body + 4, 4);
    if (avail - 8 < comp) throw PcdError{"truncated binary_compressed body"};
    storage.resize(raw);
    const int64_t got = lzf_decompress(body + 8, comp, storage.data(), raw);
    if (got == kLzfLiteralPastEnd) throw PcdError{"LZF literal run past the end of the buffer"};
    if (got == kLzfEndsInReference) throw PcdError{"LZF stream ends inside a back reference"};
    if (got == kLzfReferenceOutOfRange) throw PcdError{"LZF back reference out of range"};
    if (got != raw)
      throw PcdError{"LZF stream decoded to " + std::to_string(got) + " bytes, header says " + std::to_string(raw)};
    unsigned __int128 off = 0;  // field-major: every point's first field, then the next
    for (const Field& f : h.fields) {
      const int64_t item = static_cast<int64_t>(f.size) * f.count;
      cols.push_back({storage.data() + static_cast<size_t>(off < raw ? off : 0), item, f.type, f.size});
      off += static_cast<unsigned __int128>(item) * static_cast<uint64_t>(h.n);
    }
    if (off != raw)
      throw PcdError{"binary_compressed body holds " + std::to_string(raw) + " bytes, fields need more or fewer"};
  } else {
    throw PcdError{"unknown PCD DATA mode '" + h.mode + "'"};
  }
  extract(h, cols, out);
  return h.n;
}

void set_error(const std::string& what, char* err, int64_t err_len) {
  if (err && err_len > 0) {
    const size_t n = std::min(what.size(), static_cast<size_t>(err_len - 1));
    std::memcpy(err, what.data(), n);
    err[n] = 0;
  }
}

}  // namespace

extern "C" {

int64_t ingest_lzf_decompress(const uint8_t* in, int64_t in_len, uint8_t* out, int64_t out_len) {
  return lzf_decompress(in, in_len, out, out_len);
}

// POINTS of a PCD file's header, or -1 with a message.
int64_t ingest_pcd_points(const uint8_t* buf, int64_t len, char* err, int64_t err_len) {
  try {
    return parse_header(buf, static_cast<size_t>(len)).n;
  } catch (const PcdError& e) {
    set_error(e.what, err, err_len);
  } catch (const std::exception& e) {
    set_error(e.what(), err, err_len);
  }
  return -1;
}

// The file's points into out (cap, 6) float32; their count, or -1 with a message.
int64_t ingest_pcd_read(const uint8_t* buf, int64_t len, float* out, int64_t cap, char* err, int64_t err_len) {
  try {
    return read_pcd(buf, static_cast<size_t>(len), out, cap);
  } catch (const PcdError& e) {
    set_error(e.what, err, err_len);
  } catch (const std::exception& e) {
    set_error(e.what(), err, err_len);
  }
  return -1;
}

int64_t ingest_voxel_select_f32(const float* xyz, int64_t n, int64_t stride, double size, int32_t max_per,
                                int64_t* out) {
  return voxel_select(xyz, n, stride, size, max_per, out);
}

int64_t ingest_voxel_select_f64(const double* xyz, int64_t n, int64_t stride, double size, int32_t max_per,
                                int64_t* out) {
  return voxel_select(xyz, n, stride, size, max_per, out);
}

int64_t ingest_voxel_sweep_f32(const float* xyz, int64_t n, int64_t stride, int64_t target, const double* sizes,
                               int32_t n_sizes, int32_t max_per, int64_t* out) {
  return voxel_sweep(xyz, n, stride, target, sizes, n_sizes, max_per, out);
}

int64_t ingest_voxel_sweep_f64(const double* xyz, int64_t n, int64_t stride, int64_t target, const double* sizes,
                               int32_t n_sizes, int32_t max_per, int64_t* out) {
  return voxel_sweep(xyz, n, stride, target, sizes, n_sizes, max_per, out);
}

int64_t ingest_crop_union_f32(const float* xyz, int64_t n, int64_t stride, const int32_t* labels, const float* mn,
                              const float* mx, int32_t sub, int32_t obj, int64_t* out_idx, float* out_mask) {
  return crop_union(xyz, n, stride, labels, mn, mx, sub, obj, out_idx, out_mask);
}

int64_t ingest_crop_union_f64(const double* xyz, int64_t n, int64_t stride, const int32_t* labels, const double* mn,
                              const double* mx, int32_t sub, int32_t obj, int64_t* out_idx, float* out_mask) {
  return crop_union(xyz, n, stride, labels, mn, mx, sub, obj, out_idx, out_mask);
}

}  // extern "C"
