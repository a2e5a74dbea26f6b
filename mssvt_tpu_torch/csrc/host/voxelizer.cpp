// Native voxelizer for the host input pipeline of mssvt_tpu_torch.
//
// C++ equivalent of the reference's spconv VoxelGenerator CPU path
// (ref: pcdet/datasets/processor/data_processor.py:15-60, which wraps
// spconv's compiled Point2VoxelCPU3d), the port's copy of the JAX package's
// host voxelizer. Same semantics as
// mssvt_tpu_torch/ops/voxelize.py::voxelize_points_numpy: points walked in
// input order, voxels registered at first point, first max_points kept per
// voxel, first max_voxels voxels kept.
//
// Exposed through a plain C ABI and loaded via ctypes; built with g++ at
// first use into build/kernels/host/ (ops/voxelize.py). Single
// allocation-free hot loop with an open-addressing hash map. The voxel size
// and range arrive as doubles (the JAX package's copy takes floats), so the
// cell of every point is the float64 arithmetic of the numpy version, bit
// for bit, for any range and voxel size.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct HashMap {
    // open addressing, linear probing; key = linearized voxel index
    std::vector<int64_t> keys;
    std::vector<int32_t> vals;
    size_t mask;

    explicit HashMap(size_t capacity_pow2) {
        size_t cap = 1;
        while (cap < capacity_pow2 * 2) cap <<= 1;  // load factor <= 0.5
        keys.assign(cap, -1);
        vals.assign(cap, -1);
        mask = cap - 1;
    }

    inline int32_t* find_or_insert(int64_t key) {
        size_t h = static_cast<size_t>(key * 0x9E3779B97F4A7C15ull) & mask;
        while (true) {
            if (keys[h] == key) return &vals[h];
            if (keys[h] == -1) {
                keys[h] = key;
                return &vals[h];
            }
            h = (h + 1) & mask;
        }
    }
};

}  // namespace

extern "C" {

// Returns the number of voxels produced (<= max_voxels).
// points:  (num_points, num_features) float32, xyz first
// voxels:  out (max_voxels, max_points_per_voxel, num_features) float32, zeroed by caller
// coords:  out (max_voxels, 3) int32 (z, y, x)
// counts:  out (max_voxels,) int32, zeroed by caller
int32_t voxelize(
    const float* points, int64_t num_points, int32_t num_features,
    const double* voxel_size, const double* pc_range,
    int32_t max_points_per_voxel, int32_t max_voxels,
    float* voxels, int32_t* coords, int32_t* counts) {
    const double vx = voxel_size[0], vy = voxel_size[1], vz = voxel_size[2];
    const double x0 = pc_range[0], y0 = pc_range[1], z0 = pc_range[2];
    const int64_t nx = static_cast<int64_t>(std::llround((pc_range[3] - x0) / vx));
    const int64_t ny = static_cast<int64_t>(std::llround((pc_range[4] - y0) / vy));
    const int64_t nz = static_cast<int64_t>(std::llround((pc_range[5] - z0) / vz));

    // Size the map by the number of points, not max_voxels: keys of voxels
    // REJECTED by the max_voxels cap are also inserted (marked -2), so up to
    // num_points distinct keys can live in the table.
    HashMap map(static_cast<size_t>(num_points) + 16);
    int32_t num_voxels = 0;

    for (int64_t i = 0; i < num_points; ++i) {
        const float* p = points + i * num_features;
        const int64_t ix = static_cast<int64_t>(std::floor((p[0] - x0) / vx));
        const int64_t iy = static_cast<int64_t>(std::floor((p[1] - y0) / vy));
        const int64_t iz = static_cast<int64_t>(std::floor((p[2] - z0) / vz));
        if (ix < 0 || ix >= nx || iy < 0 || iy >= ny || iz < 0 || iz >= nz)
            continue;
        const int64_t key = (iz * ny + iy) * nx + ix;
        int32_t* slot = map.find_or_insert(key);
        if (*slot == -1) {
            if (num_voxels >= max_voxels) {
                *slot = -2;  // mark rejected so later points skip fast
                continue;
            }
            *slot = num_voxels;
            coords[num_voxels * 3 + 0] = static_cast<int32_t>(iz);
            coords[num_voxels * 3 + 1] = static_cast<int32_t>(iy);
            coords[num_voxels * 3 + 2] = static_cast<int32_t>(ix);
            ++num_voxels;
        }
        if (*slot < 0) continue;  // rejected voxel
        const int32_t v = *slot;
        if (counts[v] < max_points_per_voxel) {
            std::memcpy(
                voxels + (static_cast<int64_t>(v) * max_points_per_voxel + counts[v]) * num_features,
                p, sizeof(float) * num_features);
            ++counts[v];
        }
    }
    return num_voxels;
}

}  // extern "C"
