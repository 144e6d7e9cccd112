// Native host-side runtime components for hot_mpm.
//
// Reference equivalents (SURVEY.md §2.1): PartioIO (#19, .bgeo frame
// output), PlyIO/ObjIO (#17, mesh interchange + inside sampling), and the
// host-side particle preprocessing (counting sort) that backs seeding and
// IO streaming at 10M+ particle scale. The device compute path stays
// JAX/XLA; these are the host runtime pieces the reference also
// keeps native (C++ in ZIRAN).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC (see
// hot_mpm/native/__init__.py — built lazily and cached).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// endian helpers (classic Houdini BGEO is big-endian)
// ---------------------------------------------------------------------------

inline void put_be32(std::vector<uint8_t>& b, uint32_t v) {
    b.push_back(uint8_t(v >> 24));
    b.push_back(uint8_t(v >> 16));
    b.push_back(uint8_t(v >> 8));
    b.push_back(uint8_t(v));
}

inline void put_be16(std::vector<uint8_t>& b, uint16_t v) {
    b.push_back(uint8_t(v >> 8));
    b.push_back(uint8_t(v));
}

inline void put_bef(std::vector<uint8_t>& b, float f) {
    uint32_t v;
    std::memcpy(&v, &f, 4);
    put_be32(b, v);
}

inline void put_str(std::vector<uint8_t>& b, const char* s) {
    uint16_t n = uint16_t(std::strlen(s));
    put_be16(b, n);
    for (uint16_t i = 0; i < n; ++i) b.push_back(uint8_t(s[i]));
}

int write_all(const char* path, const std::vector<uint8_t>& buf) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    size_t w = std::fwrite(buf.data(), 1, buf.size(), f);
    std::fclose(f);
    return w == buf.size() ? 0 : -2;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// BGEO (classic Houdini v5, the format partio writes for MPM frames)
// Layout follows the public partio BGEO writer: big-endian, magic "BgeoV",
// version 5, point positions as homogeneous 4-vectors, float point
// attributes (here: v[3]), trailing extra-section terminator 0x00 0xff.
// ---------------------------------------------------------------------------

int ht_write_bgeo(const char* path, int64_t n, const float* xyz,
                  const float* vel) {
    std::vector<uint8_t> b;
    b.reserve(size_t(n) * 32 + 256);
    b.push_back('B'); b.push_back('g'); b.push_back('e'); b.push_back('o');
    b.push_back('V');
    put_be32(b, 5);                    // version
    put_be32(b, uint32_t(n));          // nPoints
    put_be32(b, 0);                    // nPrims
    put_be32(b, 0);                    // nPointGroups
    put_be32(b, 0);                    // nPrimGroups
    put_be32(b, vel ? 1 : 0);          // nPointAttrib (position excluded)
    put_be32(b, 0);                    // nVertexAttrib
    put_be32(b, 0);                    // nPrimAttrib
    put_be32(b, 0);                    // nAttrib (detail)
    if (vel) {
        put_str(b, "v");
        put_be16(b, 3);                // size (components)
        put_be32(b, 0);                // houdini type 0 = float
        put_bef(b, 0.0f); put_bef(b, 0.0f); put_bef(b, 0.0f);  // defaults
    }
    for (int64_t i = 0; i < n; ++i) {
        put_bef(b, xyz[3 * i + 0]);
        put_bef(b, xyz[3 * i + 1]);
        put_bef(b, xyz[3 * i + 2]);
        put_bef(b, 1.0f);              // homogeneous w
        if (vel) {
            put_bef(b, vel[3 * i + 0]);
            put_bef(b, vel[3 * i + 1]);
            put_bef(b, vel[3 * i + 2]);
        }
    }
    // extra sections: single terminator record (code 0x00, 0xff)
    b.push_back(0x00);
    b.push_back(0xff);
    return write_all(path, b);
}

// ---------------------------------------------------------------------------
// Binary little-endian PLY (guaranteed-interop frame output; reference
// PlyIO #17). Writes x y z [vx vy vz].
// ---------------------------------------------------------------------------

int ht_write_ply(const char* path, int64_t n, const float* xyz,
                 const float* vel) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    std::fprintf(f,
        "ply\nformat binary_little_endian 1.0\nelement vertex %lld\n"
        "property float x\nproperty float y\nproperty float z\n",
        (long long)n);
    if (vel)
        std::fprintf(f,
            "property float vx\nproperty float vy\nproperty float vz\n");
    std::fprintf(f, "end_header\n");
    for (int64_t i = 0; i < n; ++i) {
        std::fwrite(xyz + 3 * i, 4, 3, f);
        if (vel) std::fwrite(vel + 3 * i, 4, 3, f);
    }
    std::fclose(f);
    return 0;
}

// ---------------------------------------------------------------------------
// Legacy VTK binary POLYDATA point cloud (reference VtkIO #17): POINTS +
// per-point VERTICES cells (so viewers render them) + optional velocity
// VECTORS. Legacy binary VTK is big-endian.
// ---------------------------------------------------------------------------

int ht_write_vtk(const char* path, int64_t n, const float* xyz,
                 const float* vel) {
    std::vector<uint8_t> b;
    b.reserve(size_t(n) * (vel ? 44 : 32) + 512);
    auto put_text = [&](const char* s) {
        while (*s) b.push_back(uint8_t(*s++));
    };
    char hdr[128];
    put_text("# vtk DataFile Version 3.0\nhot_mpm particles\nBINARY\n"
             "DATASET POLYDATA\n");
    std::snprintf(hdr, sizeof hdr, "POINTS %lld float\n", (long long)n);
    put_text(hdr);
    for (int64_t i = 0; i < n; ++i) {
        put_bef(b, xyz[3 * i + 0]);
        put_bef(b, xyz[3 * i + 1]);
        put_bef(b, xyz[3 * i + 2]);
    }
    std::snprintf(hdr, sizeof hdr, "\nVERTICES %lld %lld\n",
                  (long long)n, (long long)(2 * n));
    put_text(hdr);
    for (int64_t i = 0; i < n; ++i) {
        put_be32(b, 1);
        put_be32(b, uint32_t(i));
    }
    if (vel) {
        std::snprintf(hdr, sizeof hdr,
                      "\nPOINT_DATA %lld\nVECTORS v float\n", (long long)n);
        put_text(hdr);
        for (int64_t i = 0; i < n; ++i) {
            put_bef(b, vel[3 * i + 0]);
            put_bef(b, vel[3 * i + 1]);
            put_bef(b, vel[3 * i + 2]);
        }
    }
    b.push_back('\n');
    return write_all(path, b);
}

// ---------------------------------------------------------------------------
// Watertight-mesh inside test by ray parity, OpenMP over samples.
// Reference: VdbLevelSet::inside / sampling for the faceless scene (#17).
// Identical rules to hot_mpm.io.mesh.points_inside_mesh (the tests assert
// bit-equality): irrational ray direction (avoids edge/diagonal double
// counts on axis-aligned meshes), |det| > 1e-12 cutoff, closed [0, 1]
// barycentric bounds, t > 1e-12.
// verts: (nv, 3) float64; faces: (nf, 3) int64; pts: (np, 3) float64;
// out: (np,) uint8.
// ---------------------------------------------------------------------------

int ht_inside_mesh(int64_t nv, const double* verts, int64_t nf,
                   const int64_t* faces, int64_t np_, const double* pts,
                   uint8_t* out) {
    (void)nv;
    // same direction as the python sampler, normalized in double
    double dx_ = 0.577350269, dy_ = 0.211324865, dz_ = 0.788675134;
    const double dn = std::sqrt(dx_ * dx_ + dy_ * dy_ + dz_ * dz_);
    dx_ /= dn; dy_ /= dn; dz_ /= dn;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t p = 0; p < np_; ++p) {
        const double ox = pts[3 * p], oy = pts[3 * p + 1], oz = pts[3 * p + 2];
        int64_t hits = 0;
        for (int64_t t = 0; t < nf; ++t) {
            const double* a = verts + 3 * faces[3 * t + 0];
            const double* bv = verts + 3 * faces[3 * t + 1];
            const double* c = verts + 3 * faces[3 * t + 2];
            const double e1x = bv[0] - a[0], e1y = bv[1] - a[1], e1z = bv[2] - a[2];
            const double e2x = c[0] - a[0], e2y = c[1] - a[1], e2z = c[2] - a[2];
            // h = d x e2
            const double hx = dy_ * e2z - dz_ * e2y;
            const double hy = dz_ * e2x - dx_ * e2z;
            const double hz = dx_ * e2y - dy_ * e2x;
            const double det = e1x * hx + e1y * hy + e1z * hz;
            if (std::fabs(det) <= 1e-12) continue;
            const double inv = 1.0 / det;
            const double sx = ox - a[0], sy = oy - a[1], sz = oz - a[2];
            const double u = (sx * hx + sy * hy + sz * hz) * inv;
            if (u < 0.0 || u > 1.0) continue;
            // q = s x e1
            const double qx = sy * e1z - sz * e1y;
            const double qy = sz * e1x - sx * e1z;
            const double qz = sx * e1y - sy * e1x;
            const double v = (qx * dx_ + qy * dy_ + qz * dz_) * inv;
            if (v < 0.0 || u + v > 1.0) continue;
            const double tt = (e2x * qx + e2y * qy + e2z * qz) * inv;
            if (tt > 1e-12) ++hits;
        }
        out[p] = uint8_t(hits & 1);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Counting sort of particles by cell id (host-side preprocessing for
// seeding / IO streaming; the device path re-bins on-chip). Returns the
// permutation (order) and per-cell segment starts (size n_cells + 1).
// ---------------------------------------------------------------------------

int ht_counting_sort(int64_t n, const int32_t* cell, int64_t n_cells,
                     int32_t* order, int32_t* starts) {
    std::vector<int32_t> count(size_t(n_cells) + 1, 0);
    for (int64_t i = 0; i < n; ++i) {
        int32_t c = cell[i];
        if (c < 0 || c >= n_cells) return -1;
        ++count[size_t(c) + 1];
    }
    for (int64_t c = 0; c < n_cells; ++c) count[c + 1] += count[c];
    std::memcpy(starts, count.data(), sizeof(int32_t) * (size_t(n_cells) + 1));
    std::vector<int32_t> cursor(count.begin(), count.end() - 1);
    for (int64_t i = 0; i < n; ++i) order[cursor[cell[i]]++] = int32_t(i);
    return 0;
}

}  // extern "C"
