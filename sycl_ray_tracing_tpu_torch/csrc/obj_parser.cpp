// Native OBJ geometry parser: the runtime counterpart of the reference's
// rapidobj dependency (reference utils.cpp:16-98 / rapidobj/).  Parses only
// geometry (v / f, fan-triangulated, all shapes flattened) plus per-face
// material *slots* by usemtl order; MTL files are small and stay parsed in
// Python.  C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct ParseState {
    std::vector<float> positions;       // xyz triples
    std::vector<int32_t> tri_vertex;    // 3 ids per triangle
    std::vector<int32_t> tri_material;  // slot per triangle (-1 none)
    std::vector<std::string> mtl_names; // usemtl slot -> name
};

static ParseState* g_state = nullptr;

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

}  // namespace

extern "C" {

// Parse the file; returns 0 on success. Outputs counts for allocation.
int32_t obj_parse(const char* path, int32_t* out_num_tris,
                  int32_t* out_num_mtl_names, int32_t* out_names_bytes) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::string data(size, '\0');
    if (fread(data.data(), 1, size, f) != (size_t)size) {
        fclose(f);
        return -2;
    }
    fclose(f);

    delete g_state;
    g_state = new ParseState();
    ParseState& st = *g_state;
    std::unordered_map<std::string, int32_t> name_to_slot;
    int32_t current = -1;

    const char* p = data.data();
    const char* end = p + data.size();
    std::vector<int32_t> face_ids;
    while (p < end) {
        const char* line_end = (const char*)memchr(p, '\n', end - p);
        if (!line_end) line_end = end;
        const char* q = skip_ws(p, line_end);
        if (q + 1 < line_end && q[0] == 'v' &&
            (q[1] == ' ' || q[1] == '\t')) {
            char* e;
            float x = strtof(q + 2, &e);
            float y = strtof(e, &e);
            float z = strtof(e, &e);
            st.positions.push_back(x);
            st.positions.push_back(y);
            st.positions.push_back(z);
        } else if (q + 1 < line_end && q[0] == 'f' &&
                   (q[1] == ' ' || q[1] == '\t')) {
            face_ids.clear();
            const char* r = q + 2;
            while (r < line_end) {
                r = skip_ws(r, line_end);
                if (r >= line_end) break;
                char* e;
                long vid = strtol(r, &e, 10);
                if (e == r) break;
                // skip /vt/vn part
                const char* s = e;
                while (s < line_end && *s != ' ' && *s != '\t' && *s != '\r')
                    ++s;
                int32_t nverts = (int32_t)(st.positions.size() / 3);
                int32_t id =
                    vid > 0 ? (int32_t)(vid - 1) : (int32_t)(nverts + vid);
                face_ids.push_back(id);
                r = s;
            }
            for (size_t k = 1; k + 1 < face_ids.size(); ++k) {
                st.tri_vertex.push_back(face_ids[0]);
                st.tri_vertex.push_back(face_ids[k]);
                st.tri_vertex.push_back(face_ids[k + 1]);
                st.tri_material.push_back(current);
            }
        } else if ((size_t)(line_end - q) > 7 &&
                   memcmp(q, "usemtl", 6) == 0) {
            const char* r = skip_ws(q + 6, line_end);
            std::string name(r, line_end - r);
            while (!name.empty() &&
                   (name.back() == '\r' || name.back() == ' '))
                name.pop_back();
            auto it = name_to_slot.find(name);
            if (it == name_to_slot.end()) {
                current = (int32_t)st.mtl_names.size();
                name_to_slot.emplace(name, current);
                st.mtl_names.push_back(name);
            } else {
                current = it->second;
            }
        }
        p = line_end + 1;
    }

    *out_num_tris = (int32_t)(st.tri_vertex.size() / 3);
    int32_t bytes = 0;
    for (const auto& n : st.mtl_names) bytes += (int32_t)n.size() + 1;
    *out_num_mtl_names = (int32_t)st.mtl_names.size();
    *out_names_bytes = bytes;
    return 0;
}

// Fill caller-allocated buffers: triangles [N*9] f32 (resolved positions),
// materials [N] i32 (usemtl slot, -1 if none), names (nul-joined).
int32_t obj_fetch(float* triangles, int32_t* materials, char* names) {
    if (!g_state) return -1;
    ParseState& st = *g_state;
    int32_t n = (int32_t)(st.tri_vertex.size() / 3);
    int32_t nv = (int32_t)(st.positions.size() / 3);
    for (int32_t i = 0; i < n; ++i) {
        for (int32_t k = 0; k < 3; ++k) {
            int32_t vid = st.tri_vertex[3 * i + k];
            if (vid < 0 || vid >= nv) vid = 0;
            triangles[9 * i + 3 * k + 0] = st.positions[3 * vid + 0];
            triangles[9 * i + 3 * k + 1] = st.positions[3 * vid + 1];
            triangles[9 * i + 3 * k + 2] = st.positions[3 * vid + 2];
        }
        materials[i] = st.tri_material[i];
    }
    char* w = names;
    for (const auto& nm : st.mtl_names) {
        memcpy(w, nm.c_str(), nm.size() + 1);
        w += nm.size() + 1;
    }
    delete g_state;
    g_state = nullptr;
    return 0;
}

}  // extern "C"
