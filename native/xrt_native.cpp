// xrt_native: native IO tier for xraytracer.
//
// The reference renderer's data loading and image output are native C++
// (tinyObjLoader in Src/scene.cpp:46-155, OpenCV imwrite in
// Src/image.h:116-143). This library is this framework's equivalent:
// a fast OBJ/MTL parser producing flat per-shape triangle arrays (the
// layout SceneBuilder consumes) and PNG/PPM writers. Exposed as a plain C
// ABI consumed from Python via ctypes (no pybind11 in the image).
//
// Semantics mirror xraytracer/scene/objloader.py exactly: fan
// triangulation, 1-based and negative OBJ indices, per-shape first usemtl
// wins, shapes split on o/g, faceless shapes dropped, utf-8 BOM tolerated.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <zlib.h>

namespace {

struct Material {
  std::string name;
  float kd[3] = {1.f, 1.f, 1.f};
  float ke[3] = {0.f, 0.f, 0.f};
  float ni = 1.f;
  int illum = 2;
  int no_surface = 0;
};

struct Shape {
  std::string name;
  std::string material;  // empty = none
  std::vector<float> vertices;  // t*9
  std::vector<float> normals;   // t*9 (empty if any corner lacked one)
  std::vector<float> uvs;       // t*6
  bool has_normals = true;
  bool has_uvs = true;
  int tri_count = 0;
};

struct ObjResult {
  std::vector<Shape> shapes;
  std::vector<Material> materials;
  std::string error;  // non-empty -> parse failed (mirrors Python's raise)
};

std::string dirOf(const std::string& path) {
  size_t p = path.find_last_of("/\\");
  return p == std::string::npos ? std::string() : path.substr(0, p + 1);
}

// whitespace tokenizer operating on one line
std::vector<std::string> tokens(const char* line) {
  std::vector<std::string> out;
  const char* p = line;
  while (*p) {
    while (*p && std::isspace((unsigned char)*p)) ++p;
    if (!*p) break;
    const char* s = p;
    while (*p && !std::isspace((unsigned char)*p)) ++p;
    out.emplace_back(s, p - s);
  }
  return out;
}

void parseMtl(const std::string& path,
              std::vector<Material>& mats,
              std::unordered_map<std::string, size_t>& index) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return;
  char line[4096];
  Material* cur = nullptr;
  while (std::fgets(line, sizeof line, f)) {
    auto tok = tokens(line);
    if (tok.empty() || tok[0][0] == '#') continue;
    if (tok[0] == "newmtl" && tok.size() > 1) {
      auto it = index.find(tok[1]);
      if (it == index.end()) {
        index[tok[1]] = mats.size();
        mats.emplace_back();
        mats.back().name = tok[1];
        cur = &mats.back();
      } else {
        cur = &mats[it->second];
      }
    } else if (!cur) {
      continue;
    } else if (tok[0] == "Kd" && tok.size() > 3) {
      for (int i = 0; i < 3; ++i) cur->kd[i] = std::strtof(tok[1 + i].c_str(), nullptr);
    } else if (tok[0] == "Ke" && tok.size() > 3) {
      for (int i = 0; i < 3; ++i) cur->ke[i] = std::strtof(tok[1 + i].c_str(), nullptr);
    } else if (tok[0] == "Ni" && tok.size() > 1) {
      cur->ni = std::strtof(tok[1].c_str(), nullptr);
    } else if (tok[0] == "illum" && tok.size() > 1) {
      cur->illum = std::atoi(tok[1].c_str());
    } else if (tok[0] == "no_surface") {
      cur->no_surface = 1;
    }
  }
  std::fclose(f);
}

// OBJ 1-based / negative-relative index -> 0-based; -2 marks out-of-range
// (including the illegal index 0 and unparsable tokens, which strtol maps
// to 0) so the caller can fail like the Python parser's IndexError instead
// of reading out of bounds (round-1 ADVICE item 2).
inline int resolveIdx(long idx, size_t n) {
  long r = idx > 0 ? idx - 1 : (long)n + idx;
  return (r < 0 || r >= (long)n) ? -2 : (int)r;
}

struct Corner { int v, t, n; };

struct RawShape {
  std::string name;
  std::string material;
  std::vector<Corner> tris;  // 3 corners per triangle
};

}  // namespace

extern "C" {

ObjResult* xrt_parse_obj(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;

  std::vector<float> vs, vns, vts;  // flat xyz / xyz / uv
  std::vector<RawShape> raw;
  RawShape* cur = nullptr;
  auto mats = new ObjResult();
  std::unordered_map<std::string, size_t> matIndex;

  auto newShape = [&](std::string name) {
    raw.emplace_back();
    cur = &raw.back();
    if (name.empty()) name = "shape" + std::to_string(raw.size() - 1);
    cur->name = std::move(name);
  };

  char line[8192];
  bool first = true;
  while (std::fgets(line, sizeof line, f)) {
    char* p = line;
    if (first) {  // strip a utf-8 BOM
      if ((unsigned char)p[0] == 0xEF && (unsigned char)p[1] == 0xBB &&
          (unsigned char)p[2] == 0xBF)
        p += 3;
      first = false;
    }
    auto tok = tokens(p);
    if (tok.empty() || tok[0][0] == '#') continue;
    const std::string& cmd = tok[0];
    if (cmd == "v" && tok.size() > 3) {
      for (int i = 0; i < 3; ++i) vs.push_back(std::strtof(tok[1 + i].c_str(), nullptr));
    } else if (cmd == "vn" && tok.size() > 3) {
      for (int i = 0; i < 3; ++i) vns.push_back(std::strtof(tok[1 + i].c_str(), nullptr));
    } else if (cmd == "vt" && tok.size() > 2) {
      for (int i = 0; i < 2; ++i) vts.push_back(std::strtof(tok[1 + i].c_str(), nullptr));
    } else if (cmd == "mtllib" && tok.size() > 1) {
      parseMtl(dirOf(path) + tok[1], mats->materials, matIndex);
    } else if (cmd == "o" || cmd == "g") {
      newShape(tok.size() > 1 ? tok[1] : std::string());
    } else if (cmd == "usemtl" && tok.size() > 1) {
      if (!cur) newShape(std::string());
      if (cur->material.empty()) cur->material = tok[1];
    } else if (cmd == "f") {
      if (!cur) newShape(std::string());
      std::vector<Corner> corners;
      for (size_t w = 1; w < tok.size(); ++w) {
        const char* s = tok[w].c_str();
        char* end;
        Corner c{-1, -1, -1};
        long vi = std::strtol(s, &end, 10);
        c.v = resolveIdx(vi, vs.size() / 3);
        if (*end == '/') {
          s = end + 1;
          if (*s != '/') {
            long ti = std::strtol(s, &end, 10);
            c.t = resolveIdx(ti, vts.size() / 2);
          } else {
            end = (char*)s;
          }
          if (*end == '/') {
            long ni = std::strtol(end + 1, &end, 10);
            c.n = resolveIdx(ni, vns.size() / 3);
          }
        }
        if (c.v == -2 || c.t == -2 || c.n == -2) {
          mats->error = "invalid face index '" + tok[w] + "' in " + path;
          std::fclose(f);
          return mats;
        }
        corners.push_back(c);
      }
      for (size_t k = 1; k + 1 < corners.size(); ++k) {
        cur->tris.push_back(corners[0]);
        cur->tris.push_back(corners[k]);
        cur->tris.push_back(corners[k + 1]);
      }
    }
  }
  std::fclose(f);

  for (auto& rs : raw) {
    if (rs.tris.empty()) continue;  // faceless shapes dropped
    Shape sh;
    sh.name = rs.name;
    sh.material = rs.material;
    sh.tri_count = (int)(rs.tris.size() / 3);
    sh.has_normals = true;
    sh.has_uvs = true;
    for (const auto& c : rs.tris) {
      if (c.n < 0) sh.has_normals = false;
      if (c.t < 0) sh.has_uvs = false;
    }
    sh.vertices.reserve(rs.tris.size() * 3);
    if (sh.has_normals) sh.normals.reserve(rs.tris.size() * 3);
    if (sh.has_uvs) sh.uvs.reserve(rs.tris.size() * 2);
    for (const auto& c : rs.tris) {
      for (int i = 0; i < 3; ++i) sh.vertices.push_back(vs[3 * c.v + i]);
      if (sh.has_normals)
        for (int i = 0; i < 3; ++i) sh.normals.push_back(vns[3 * c.n + i]);
      if (sh.has_uvs)
        for (int i = 0; i < 2; ++i) sh.uvs.push_back(vts[2 * c.t + i]);
    }
    mats->shapes.push_back(std::move(sh));
  }
  return mats;
}

void xrt_free_obj(ObjResult* r) { delete r; }

// empty string when the parse succeeded
const char* xrt_obj_error(ObjResult* r) { return r->error.c_str(); }

int xrt_obj_num_shapes(ObjResult* r) { return (int)r->shapes.size(); }
const char* xrt_obj_shape_name(ObjResult* r, int i) { return r->shapes[i].name.c_str(); }
const char* xrt_obj_shape_material(ObjResult* r, int i) { return r->shapes[i].material.c_str(); }
int xrt_obj_shape_tri_count(ObjResult* r, int i) { return r->shapes[i].tri_count; }
const float* xrt_obj_shape_vertices(ObjResult* r, int i) { return r->shapes[i].vertices.data(); }
const float* xrt_obj_shape_normals(ObjResult* r, int i) {
  return r->shapes[i].has_normals ? r->shapes[i].normals.data() : nullptr;
}
const float* xrt_obj_shape_uvs(ObjResult* r, int i) {
  return r->shapes[i].has_uvs ? r->shapes[i].uvs.data() : nullptr;
}
int xrt_obj_num_materials(ObjResult* r) { return (int)r->materials.size(); }
const char* xrt_obj_material_name(ObjResult* r, int i) { return r->materials[i].name.c_str(); }
void xrt_obj_material_props(ObjResult* r, int i, float* kd, float* ke,
                            float* ni, int* illum, int* no_surface) {
  const Material& m = r->materials[i];
  std::memcpy(kd, m.kd, 3 * sizeof(float));
  std::memcpy(ke, m.ke, 3 * sizeof(float));
  *ni = m.ni;
  *illum = m.illum;
  *no_surface = m.no_surface;
}

// ---------------------------------------------------------------------------
// image writers (reference: Src/image.h:92-143 PPM + OpenCV export)

static void pngChunk(FILE* f, const char tag[4], const unsigned char* data,
                     uint32_t len) {
  unsigned char hdr[8];
  hdr[0] = (len >> 24) & 0xFF; hdr[1] = (len >> 16) & 0xFF;
  hdr[2] = (len >> 8) & 0xFF;  hdr[3] = len & 0xFF;
  std::memcpy(hdr + 4, tag, 4);
  std::fwrite(hdr, 1, 8, f);
  if (len) std::fwrite(data, 1, len, f);
  uLong crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, (const Bytef*)tag, 4);
  if (len) crc = crc32(crc, data, len);
  unsigned char cb[4] = {
      (unsigned char)((crc >> 24) & 0xFF), (unsigned char)((crc >> 16) & 0xFF),
      (unsigned char)((crc >> 8) & 0xFF), (unsigned char)(crc & 0xFF)};
  std::fwrite(cb, 1, 4, f);
}

int xrt_write_png(const char* path, const unsigned char* rgb, int w, int h) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  static const unsigned char sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  std::fwrite(sig, 1, 8, f);
  unsigned char ihdr[13];
  ihdr[0] = (w >> 24) & 0xFF; ihdr[1] = (w >> 16) & 0xFF;
  ihdr[2] = (w >> 8) & 0xFF;  ihdr[3] = w & 0xFF;
  ihdr[4] = (h >> 24) & 0xFF; ihdr[5] = (h >> 16) & 0xFF;
  ihdr[6] = (h >> 8) & 0xFF;  ihdr[7] = h & 0xFF;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  pngChunk(f, "IHDR", ihdr, 13);

  // filter byte 0 per scanline
  std::vector<unsigned char> raw((size_t)h * (1 + (size_t)w * 3));
  for (int y = 0; y < h; ++y) {
    raw[(size_t)y * (1 + (size_t)w * 3)] = 0;
    std::memcpy(&raw[(size_t)y * (1 + (size_t)w * 3) + 1],
                rgb + (size_t)y * w * 3, (size_t)w * 3);
  }
  uLongf bound = compressBound((uLong)raw.size());
  std::vector<unsigned char> comp(bound);
  if (compress2(comp.data(), &bound, raw.data(), (uLong)raw.size(), 6) != Z_OK) {
    std::fclose(f);
    return 2;
  }
  pngChunk(f, "IDAT", comp.data(), (uint32_t)bound);
  pngChunk(f, "IEND", nullptr, 0);
  std::fclose(f);
  return 0;
}

int xrt_write_ppm(const char* path, const unsigned char* rgb, int w, int h) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  std::fprintf(f, "P6\n%d %d\n255\n", w, h);
  std::fwrite(rgb, 1, (size_t)w * h * 3, f);
  std::fclose(f);
  return 0;
}

}  // extern "C"
