// Native mesh toolkit of the port's robot builder (host C++, no CUDA).
//
// The port's own copy of the JAX package's toolkit: binary STL parsing,
// exact solid mass properties of a closed triangle mesh (divergence
// theorem, the twin of MuJoCo's inertiafromgeom) and farthest-point
// sampling of contact points, over a C ABI.
//
//   * stl_tri_count / stl_read      -- binary STL parsing
//   * mass_properties               -- mass, COM and inertia about the COM
//                                      of float32 triangles, accumulated in
//                                      double
//   * farthest_point_sample         -- contact-point selection on hulls
//
// Built with g++ -O3 -shared -fPIC by meshtools.py on first use.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// Returns triangle count of a binary STL buffer, or -1 if not binary.
int stl_tri_count(const uint8_t* buf, long size) {
    if (size < 84) return -1;
    uint32_t n;
    std::memcpy(&n, buf + 80, 4);
    if ((long)(84 + (uint64_t)n * 50) != size) return -1;
    return (int)n;
}

// Parse binary STL triangles into out[n_tri*9] (v0 v1 v2 xyz each).
int stl_read(const uint8_t* buf, long size, float* out) {
    int n = stl_tri_count(buf, size);
    if (n < 0) return -1;
    for (int i = 0; i < n; ++i) {
        const uint8_t* rec = buf + 84 + (uint64_t)i * 50;
        std::memcpy(out + i * 9, rec + 12, 36);  // skip normal, copy 3 verts
    }
    return n;
}

// Exact solid mass properties of a closed triangle mesh.
// tris: n*9 floats; out: [mass, com xyz, Ixx, Iyy, Izz, Ixy, Ixz, Iyz]
// (inertia about the COM).
void mass_properties(const float* tris, int n_tris, double density,
                     double* out) {
    double vol6 = 0.0;
    double com[3] = {0, 0, 0};
    double C[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
    for (int t = 0; t < n_tris; ++t) {
        const float* v0 = tris + t * 9;
        const float* v1 = v0 + 3;
        const float* v2 = v0 + 6;
        double cx = (double)v1[1] * v2[2] - (double)v1[2] * v2[1];
        double cy = (double)v1[2] * v2[0] - (double)v1[0] * v2[2];
        double cz = (double)v1[0] * v2[1] - (double)v1[1] * v2[0];
        double d = v0[0] * cx + v0[1] * cy + v0[2] * cz;  // 6*signed tet vol
        vol6 += d;
        for (int a = 0; a < 3; ++a)
            com[a] += d * (v0[a] + v1[a] + v2[a]) / 4.0;
        for (int a = 0; a < 3; ++a) {
            double sa = v0[a] + v1[a] + v2[a];
            for (int b = a; b < 3; ++b) {
                double sb = v0[b] + v1[b] + v2[b];
                double p = (double)v0[a] * v0[b] + (double)v1[a] * v1[b] +
                           (double)v2[a] * v2[b];
                C[a][b] += d * (sa * sb + p) / 120.0;
            }
        }
    }
    double volume = vol6 / 6.0;
    double mass = density * volume;
    for (int a = 0; a < 3; ++a) com[a] /= 6.0 * volume;
    // C holds integral x_a x_b dV (upper); scale, shift to COM
    double Cc[3][3];
    for (int a = 0; a < 3; ++a)
        for (int b = a; b < 3; ++b) {
            double v = density * C[a][b] - mass * com[a] * com[b];
            Cc[a][b] = v;
            Cc[b][a] = v;
        }
    double tr = Cc[0][0] + Cc[1][1] + Cc[2][2];
    out[0] = mass;
    out[1] = com[0]; out[2] = com[1]; out[3] = com[2];
    out[4] = tr - Cc[0][0];
    out[5] = tr - Cc[1][1];
    out[6] = tr - Cc[2][2];
    out[7] = -Cc[0][1];
    out[8] = -Cc[0][2];
    out[9] = -Cc[1][2];
}

// Farthest-point sampling of k points from pts (n*3), seeded at the
// lowest-z point (ground-contact bias). Writes k indices to out_idx.
void farthest_point_sample(const float* pts, int n, int k, int* out_idx) {
    std::vector<float> dist(n, 1e30f);
    int cur = 0;
    float zmin = 1e30f;
    for (int i = 0; i < n; ++i)
        if (pts[i * 3 + 2] < zmin) { zmin = pts[i * 3 + 2]; cur = i; }
    for (int j = 0; j < k; ++j) {
        out_idx[j] = cur;
        const float* c = pts + cur * 3;
        int nxt = 0;
        float best = -1.0f;
        for (int i = 0; i < n; ++i) {
            float dx = pts[i * 3] - c[0];
            float dy = pts[i * 3 + 1] - c[1];
            float dz = pts[i * 3 + 2] - c[2];
            float d = dx * dx + dy * dy + dz * dz;
            if (d < dist[i]) dist[i] = d;
            if (dist[i] > best) { best = dist[i]; nxt = i; }
        }
        cur = nxt;
    }
}

}  // extern "C"
