// Marching tetrahedra isosurface extraction, in C++ on the host.
//
// The port's own copy of tdgp/native/marching_cubes.cpp. Each cube of the
// density grid is split into 6 tetrahedra sharing the 0-6 diagonal; each
// tetrahedron's sign case emits 1-2 triangles with linear interpolation
// along its edges, with the vertex order of the numpy version
// (tdgp_torch/geometry.py:_marching_tetrahedra_numpy), whose triangles come
// in another order and are interpolated in float64. Exposed through a C
// interface and bound with ctypes (tdgp_torch/native/__init__.py), which
// builds it with g++ into tdgp_torch/build/ at first use.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
};

// cube corner offsets
static const int CORNERS[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

// six tetrahedra sharing the 0-6 diagonal
static const int TETS[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

inline Vec3 interp(float level, const Vec3& pa, const Vec3& pb, float va, float vb) {
    float d = vb - va;
    float t = (d > -1e-12f && d < 1e-12f) ? 0.5f : (level - va) / d;
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    return Vec3{pa.x + t * (pb.x - pa.x), pa.y + t * (pb.y - pa.y),
                pa.z + t * (pb.z - pa.z)};
}

struct TriBuffer {
    std::vector<float> verts;  // 9 floats per triangle

    void push(const Vec3& a, const Vec3& b, const Vec3& c) {
        const Vec3 pts[3] = {a, b, c};
        for (const auto& p : pts) {
            verts.push_back(p.x);
            verts.push_back(p.y);
            verts.push_back(p.z);
        }
    }
};

void process_tet(TriBuffer& out, float level, const Vec3 p[4], const float v[4]) {
    int code = 0;
    for (int i = 0; i < 4; ++i)
        if (v[i] > level) code |= (1 << i);
    if (code == 0 || code == 15) return;

    // single-corner cases: corner ci separated, winding as in the numpy version
    auto tri_single = [&](int ci, int o0, int o1, int o2, bool flip) {
        Vec3 a = interp(level, p[ci], p[o0], v[ci], v[o0]);
        Vec3 b = interp(level, p[ci], p[o1], v[ci], v[o1]);
        Vec3 c = interp(level, p[ci], p[o2], v[ci], v[o2]);
        if (flip) out.push(c, b, a);
        else out.push(a, b, c);
    };
    auto quad_double = [&](int a, int b, int c, int d) {
        // corners {a,b} on one side, {c,d} on the other
        Vec3 q0 = interp(level, p[a], p[c], v[a], v[c]);
        Vec3 q1 = interp(level, p[a], p[d], v[a], v[d]);
        Vec3 q2 = interp(level, p[b], p[d], v[b], v[d]);
        Vec3 q3 = interp(level, p[b], p[c], v[b], v[c]);
        out.push(q0, q1, q2);
        out.push(q0, q2, q3);
    };

    switch (code) {
        case 1:  tri_single(0, 1, 2, 3, false); break;
        case 14: tri_single(0, 1, 2, 3, true);  break;
        case 2:  tri_single(1, 0, 3, 2, false); break;
        case 13: tri_single(1, 0, 3, 2, true);  break;
        case 4:  tri_single(2, 0, 1, 3, false); break;
        case 11: tri_single(2, 0, 1, 3, true);  break;
        case 8:  tri_single(3, 0, 2, 1, false); break;
        case 7:  tri_single(3, 0, 2, 1, true);  break;
        case 3:  quad_double(0, 1, 2, 3); break;
        case 12: quad_double(2, 3, 0, 1); break;
        case 5:  quad_double(0, 2, 1, 3); break;
        case 10: quad_double(1, 3, 0, 2); break;
        case 9:  quad_double(0, 3, 1, 2); break;
        case 6:  quad_double(1, 2, 0, 3); break;
        default: break;
    }
}

}  // namespace

extern "C" {

// Returns the number of triangles; caller fetches data with mc_get_triangles
// and releases with mc_free. Thread-unsafe handle-based API kept trivially
// simple for ctypes.
void* mc_run(const float* values, int nx, int ny, int nz, float level,
             int64_t* num_triangles) {
    auto* buf = new TriBuffer();
    const int64_t sy = nz;           // strides for [x][y][z] C-order
    const int64_t sx = (int64_t)ny * nz;

    for (int x = 0; x + 1 < nx; ++x) {
        for (int y = 0; y + 1 < ny; ++y) {
            for (int z = 0; z + 1 < nz; ++z) {
                float cv[8];
                Vec3 cp[8];
                bool any_in = false, any_out = false;
                for (int i = 0; i < 8; ++i) {
                    int cx = x + CORNERS[i][0];
                    int cy = y + CORNERS[i][1];
                    int cz = z + CORNERS[i][2];
                    cv[i] = values[cx * sx + cy * sy + cz];
                    cp[i] = Vec3{(float)cx, (float)cy, (float)cz};
                    (cv[i] > level ? any_in : any_out) = true;
                }
                if (!any_in || !any_out) continue;  // fully inside/outside
                for (const auto& tet : TETS) {
                    Vec3 tp[4];
                    float tv[4];
                    for (int i = 0; i < 4; ++i) {
                        tp[i] = cp[tet[i]];
                        tv[i] = cv[tet[i]];
                    }
                    process_tet(*buf, level, tp, tv);
                }
            }
        }
    }
    *num_triangles = (int64_t)(buf->verts.size() / 9);
    return buf;
}

void mc_get_triangles(void* handle, float* out) {
    auto* buf = static_cast<TriBuffer*>(handle);
    std::memcpy(out, buf->verts.data(), buf->verts.size() * sizeof(float));
}

void mc_free(void* handle) {
    delete static_cast<TriBuffer*>(handle);
}

}  // extern "C"
