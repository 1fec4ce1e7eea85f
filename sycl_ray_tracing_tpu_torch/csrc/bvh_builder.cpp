// Native BVH builder: binned-SAH construction -> threaded (skip-link) DFS
// layout, the runtime counterpart of ops/bvh.py's Morton-balanced builder.
//
// This is the framework's native-runtime component replacing the
// reference's host-side octree construction (reference include/bvh.h:83-125,
// source/bvh.cpp:19-60) with a production-quality binned SAH build
// (Wald 2007 style), emitting the exact packed arrays the JAX traversal
// consumes (nodes_box [M,8] f32, nodes_meta [M,4] i32, slot order [Np]).
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).
//
// Build: make -C sycl_ray_tracing_tpu/native

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
    Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
    Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    void grow(const AABB& o) {
        lo = vmin(lo, o.lo);
        hi = vmax(hi, o.hi);
    }
    void grow(const Vec3& p) {
        lo = vmin(lo, p);
        hi = vmax(hi, p);
    }
    float area() const {
        float dx = std::max(0.0f, hi.x - lo.x);
        float dy = std::max(0.0f, hi.y - lo.y);
        float dz = std::max(0.0f, hi.z - lo.z);
        return 2.0f * (dx * dy + dy * dz + dz * dx);
    }
};

struct BuildNode {
    AABB box;
    int32_t first = 0;   // into the index array (leaves)
    int32_t count = -1;  // -1 = internal
    int32_t left = -1;
    int32_t right = -1;
};

constexpr int kBins = 16;

struct Builder {
    const float* tris;  // [N,9]
    int32_t n;
    int32_t leaf_size;
    std::vector<AABB> prim_box;
    std::vector<Vec3> centroid;
    std::vector<int32_t> index;
    std::vector<BuildNode> nodes;

    void init() {
        prim_box.resize(n);
        centroid.resize(n);
        index.resize(n);
        for (int32_t i = 0; i < n; ++i) {
            const float* t = tris + 9 * i;
            AABB b;
            b.grow(Vec3{t[0], t[1], t[2]});
            b.grow(Vec3{t[3], t[4], t[5]});
            b.grow(Vec3{t[6], t[7], t[8]});
            prim_box[i] = b;
            centroid[i] = Vec3{(b.lo.x + b.hi.x) * 0.5f,
                               (b.lo.y + b.hi.y) * 0.5f,
                               (b.lo.z + b.hi.z) * 0.5f};
            index[i] = i;
        }
        nodes.reserve(2 * n / std::max(1, leaf_size) + 64);
    }

    int32_t build(int32_t first, int32_t count) {
        int32_t node_id = (int32_t)nodes.size();
        nodes.emplace_back();
        AABB box;
        for (int32_t i = first; i < first + count; ++i)
            box.grow(prim_box[index[i]]);
        nodes[node_id].box = box;

        if (count <= leaf_size) {
            nodes[node_id].first = first;
            nodes[node_id].count = count;
            return node_id;
        }

        // centroid bounds for binning
        AABB cb;
        for (int32_t i = first; i < first + count; ++i)
            cb.grow(centroid[index[i]]);

        int best_axis = -1;
        int best_split = -1;
        float best_cost = FLT_MAX;
        const float parent_area = std::max(box.area(), 1e-20f);

        for (int axis = 0; axis < 3; ++axis) {
            float lo = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
            float hi = axis == 0 ? cb.hi.x : (axis == 1 ? cb.hi.y : cb.hi.z);
            if (hi - lo < 1e-12f) continue;
            float scale = kBins / (hi - lo);

            AABB bin_box[kBins];
            int32_t bin_cnt[kBins] = {0};
            for (int32_t i = first; i < first + count; ++i) {
                const Vec3& c = centroid[index[i]];
                float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
                int b = std::min(kBins - 1, (int)((v - lo) * scale));
                bin_box[b].grow(prim_box[index[i]]);
                bin_cnt[b]++;
            }
            // sweep
            AABB acc;
            float left_area[kBins];
            int32_t left_cnt[kBins];
            int32_t running = 0;
            for (int b = 0; b < kBins - 1; ++b) {
                acc.grow(bin_box[b]);
                running += bin_cnt[b];
                left_area[b] = acc.area();
                left_cnt[b] = running;
            }
            AABB acc_r;
            for (int b = kBins - 1; b >= 1; --b) {
                acc_r.grow(bin_box[b]);
                int32_t lc = left_cnt[b - 1];
                int32_t rc = count - lc;
                if (lc == 0 || rc == 0) continue;
                float cost =
                    (left_area[b - 1] * lc + acc_r.area() * rc) / parent_area;
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = axis;
                    best_split = b;  // bins [0,b) left
                }
            }
        }

        int32_t mid;
        if (best_axis < 0) {
            // degenerate centroids: median split on the index order
            mid = first + count / 2;
        } else {
            float lo = best_axis == 0   ? cb.lo.x
                       : best_axis == 1 ? cb.lo.y
                                        : cb.lo.z;
            float hi = best_axis == 0   ? cb.hi.x
                       : best_axis == 1 ? cb.hi.y
                                        : cb.hi.z;
            float scale = kBins / (hi - lo);
            int axis = best_axis;
            auto* cent = centroid.data();
            int32_t* mid_ptr = std::partition(
                index.data() + first, index.data() + first + count,
                [&](int32_t i) {
                    const Vec3& c = cent[i];
                    float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
                    int b = std::min(kBins - 1, (int)((v - lo) * scale));
                    return b < best_split;
                });
            mid = (int32_t)(mid_ptr - index.data());
            if (mid == first || mid == first + count) mid = first + count / 2;
        }

        int32_t l = build(first, mid - first);
        int32_t r = build(mid, first + count - mid);
        nodes[node_id].left = l;
        nodes[node_id].right = r;
        return node_id;
    }
};

// DFS flatten with skip links into the packed layout.
struct Flattener {
    const std::vector<BuildNode>& nodes;
    const std::vector<int32_t>& index;
    int32_t leaf_size;
    float* nodes_box;    // [M,8]
    int32_t* nodes_meta; // [M,4]
    int32_t* slot_order; // [Np] original tri index per padded slot
    int32_t cursor = 0;
    int32_t slot_cursor = 0;

    int32_t subtree_size(int32_t id) const {
        const BuildNode& nd = nodes[id];
        if (nd.count >= 0) return 1;
        return 1 + subtree_size(nd.left) + subtree_size(nd.right);
    }

    void emit(int32_t id, int32_t skip_to) {
        const BuildNode& nd = nodes[id];
        int32_t my = cursor++;
        nodes_box[my * 8 + 0] = nd.box.lo.x;
        nodes_box[my * 8 + 1] = nd.box.lo.y;
        nodes_box[my * 8 + 2] = nd.box.lo.z;
        nodes_box[my * 8 + 3] = nd.box.hi.x;
        nodes_box[my * 8 + 4] = nd.box.hi.y;
        nodes_box[my * 8 + 5] = nd.box.hi.z;
        nodes_box[my * 8 + 6] = 0.0f;
        nodes_box[my * 8 + 7] = 0.0f;
        if (nd.count >= 0) {
            // leaf: copy its primitives into padded slots
            nodes_meta[my * 4 + 0] = slot_cursor;
            nodes_meta[my * 4 + 1] = nd.count;
            for (int32_t i = 0; i < nd.count; ++i)
                slot_order[slot_cursor + i] = index[nd.first + i];
            for (int32_t i = nd.count; i < leaf_size; ++i)
                slot_order[slot_cursor + i] = 0;  // padding (masked out)
            slot_cursor += leaf_size;
        } else {
            nodes_meta[my * 4 + 0] = 0;
            nodes_meta[my * 4 + 1] = -1;
        }
        nodes_meta[my * 4 + 3] = 0;
        if (nd.count >= 0) {
            nodes_meta[my * 4 + 2] = skip_to;
        } else {
            int32_t right_at = my + 1 + subtree_size(nd.left);
            nodes_meta[my * 4 + 2] = skip_to;
            emit(nd.left, right_at);
            emit(nd.right, skip_to);
        }
    }
};

}  // namespace

extern "C" {

// Pass 1: build and return sizes. Returns handle id (>=0) or -1 on error.
// For simplicity the builder is single-use global state guarded by the GIL
// on the Python side (ctypes calls hold the GIL by default).
static Builder* g_builder = nullptr;

int32_t bvh_build(const float* tris, int32_t n, int32_t leaf_size,
                  int32_t* out_num_nodes, int32_t* out_num_leaves) {
    delete g_builder;
    g_builder = new Builder{tris, n, leaf_size};
    g_builder->init();
    g_builder->build(0, n);
    int32_t leaves = 0;
    for (const auto& nd : g_builder->nodes)
        if (nd.count >= 0) leaves++;
    *out_num_nodes = (int32_t)g_builder->nodes.size();
    *out_num_leaves = leaves;
    return 0;
}

// Pass 2: flatten into caller-allocated arrays.
// nodes_box: [num_nodes*8] f32; nodes_meta: [num_nodes*4] i32;
// slot_order: [num_leaves*leaf_size] i32.
int32_t bvh_flatten(float* nodes_box, int32_t* nodes_meta,
                    int32_t* slot_order) {
    if (!g_builder) return -1;
    Flattener f{g_builder->nodes, g_builder->index, g_builder->leaf_size,
                nodes_box, nodes_meta, slot_order};
    f.emit(0, (int32_t)g_builder->nodes.size());
    delete g_builder;
    g_builder = nullptr;
    return 0;
}

}  // extern "C"
