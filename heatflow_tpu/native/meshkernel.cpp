// heatflow_tpu native mesh/assembly kernels.
//
// Host-side C++ counterpart of the reference stack's native meshing and
// element-assembly layers (gmsh C++ and DOLFINx/FFCx generated C kernels,
// ref mesh_and_materials/mesh.py:81-149 driving gmsh, space_and_forms.py
// driving FFCx). The device compute path stays JAX/XLA; this library accelerates
// the one-time host-side setup: graded axis generation, cell tagging, and
// exact closed-form P1 stencil assembly for large meshes.
//
// Exposed via a C ABI for ctypes; the Python layer falls back to the numpy
// implementation when the shared object is unavailable.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Graded 1D axis: spans are triples (a, b, h); sizing at a point is the min
// over covering spans else default_h. Mirrors mesh/axes.py::graded_axis.
// Returns the number of coordinates written, or -1 if out_cap is too small.
// ---------------------------------------------------------------------------
long hf_graded_axis(double lo, double hi, const double* spans, long n_spans,
                    double default_h, double* out, long out_cap) {
    std::vector<double> brk;
    brk.push_back(lo);
    brk.push_back(hi);
    for (long s = 0; s < n_spans; ++s) {
        for (int e = 0; e < 2; ++e) {
            double p = spans[3 * s + e];
            if (p > lo && p < hi) brk.push_back(p);
        }
    }
    std::sort(brk.begin(), brk.end());
    double scale = std::max(std::max(std::fabs(lo), std::fabs(hi)), 1e-30);
    std::vector<double> keep;
    keep.push_back(brk[0]);
    for (size_t i = 1; i < brk.size(); ++i)
        if (brk[i] - keep.back() > 1e-12 * scale) keep.push_back(brk[i]);

    long n = 0;
    if (n >= out_cap) return -1;
    out[n++] = keep[0];
    for (size_t i = 0; i + 1 < keep.size(); ++i) {
        double a = keep[i], b = keep[i + 1];
        double mid = 0.5 * (a + b);
        double h = default_h;
        for (long s = 0; s < n_spans; ++s) {
            if (spans[3 * s] <= mid && mid <= spans[3 * s + 1])
                h = std::min(h, spans[3 * s + 2]);
        }
        long cells = (long)std::ceil((b - a) / h - 1e-9);
        if (cells < 1) cells = 1;
        for (long c = 1; c <= cells; ++c) {
            if (n >= out_cap) return -1;
            out[n++] = a + (b - a) * (double)c / (double)cells;
        }
    }
    return n;
}

// ---------------------------------------------------------------------------
// Cell tagging: first material rectangle containing the cell centroid wins
// (1-based tags; 0 = uncovered). Mirrors structured.py::_assign_cell_tags.
// ---------------------------------------------------------------------------
void hf_assign_cell_tags(const double* z, long nz, const double* r, long nr,
                         const double* rects, long n_mats, int32_t* tags) {
    for (long i = 0; i + 1 < nz; ++i) {
        double zc = 0.5 * (z[i] + z[i + 1]);
        for (long j = 0; j + 1 < nr; ++j) {
            double rc = 0.5 * (r[j] + r[j + 1]);
            int32_t tag = 0;
            for (long m = 0; m < n_mats; ++m) {
                const double* q = rects + 4 * m;
                if (zc >= q[0] && zc <= q[1] && rc >= q[2] && rc <= q[3]) {
                    tag = (int32_t)(m + 1);
                    break;
                }
            }
            tags[i * (nr - 1) + j] = tag;
        }
    }
}

// ---------------------------------------------------------------------------
// Exact P1 stencil assembly on the structured triangulated grid.
//
// Layout (all row-major double):
//   K, M:          (n_mats, 7, nz, nr)  r-weighted stiffness / mass
//   K_flat,M_flat: (n_mats, 7, nz, nr)  unweighted variants
//   G_r, G_z:      (7, nz, nr)          gradient-projection rhs operators
// Offsets order matches ops/stencil.py::OFFSETS:
//   (0,0),(1,0),(-1,0),(0,1),(0,-1),(1,1),(-1,-1)
// ---------------------------------------------------------------------------
namespace {

static const int OFFS[7][2] = {{0, 0}, {1, 0}, {-1, 0}, {0, 1},
                               {0, -1}, {1, 1}, {-1, -1}};

inline int off_index(int di, int dj) {
    for (int k = 0; k < 7; ++k)
        if (OFFS[k][0] == di && OFFS[k][1] == dj) return k;
    return -1;
}

struct Tri {
    // vertex grid offsets within the quad
    int vp[3][2];
};

}  // namespace

void hf_assemble_stencils(const double* z, long nz, const double* r, long nr,
                          const int32_t* tags, long n_mats, double* K,
                          double* M, double* K_flat, double* M_flat,
                          double* G_r, double* G_z) {
    const long N = nz * nr;
    const long mat_stride = 7 * N;
    std::memset(K, 0, sizeof(double) * n_mats * mat_stride);
    std::memset(M, 0, sizeof(double) * n_mats * mat_stride);
    std::memset(K_flat, 0, sizeof(double) * n_mats * mat_stride);
    std::memset(M_flat, 0, sizeof(double) * n_mats * mat_stride);
    std::memset(G_r, 0, sizeof(double) * mat_stride);
    std::memset(G_z, 0, sizeof(double) * mat_stride);

    static const Tri TRIS[2] = {
        {{{0, 0}, {1, 0}, {1, 1}}},   // lower
        {{{0, 0}, {1, 1}, {0, 1}}},   // upper
    };

    for (long i = 0; i + 1 < nz; ++i) {
        for (long j = 0; j + 1 < nr; ++j) {
            int32_t tag = tags[i * (nr - 1) + j];
            if (tag <= 0 || tag > n_mats) continue;
            long m = tag - 1;
            for (int t = 0; t < 2; ++t) {
                const Tri& tri = TRIS[t];
                double px[3], py[3];
                for (int a = 0; a < 3; ++a) {
                    px[a] = z[i + tri.vp[a][0]];
                    py[a] = r[j + tri.vp[a][1]];
                }
                double d1x = px[1] - px[0], d1y = py[1] - py[0];
                double d2x = px[2] - px[0], d2y = py[2] - py[0];
                double det = d1x * d2y - d1y * d2x;
                double area = 0.5 * std::fabs(det);
                double rbar = (py[0] + py[1] + py[2]) / 3.0;
                // shape gradients
                double gx[3], gy[3];
                gx[0] = (py[1] - py[2]) / det;
                gx[1] = (py[2] - py[0]) / det;
                gx[2] = (py[0] - py[1]) / det;
                gy[0] = (px[2] - px[1]) / det;
                gy[1] = (px[0] - px[2]) / det;
                gy[2] = (px[1] - px[0]) / det;
                double rsum = py[0] + py[1] + py[2];

                for (int a = 0; a < 3; ++a) {
                    long ia = i + tri.vp[a][0];
                    long ja = j + tri.vp[a][1];
                    long node = ia * nr + ja;
                    double wa = area * (py[a] + rsum) / 12.0;  // ∫ φ_a r
                    for (int b = 0; b < 3; ++b) {
                        int di = tri.vp[b][0] - tri.vp[a][0];
                        int dj = tri.vp[b][1] - tri.vp[a][1];
                        int k = off_index(di, dj);
                        long idx = (long)k * N + node;
                        double gg = gx[a] * gx[b] + gy[a] * gy[b];
                        // r-weighted stiffness (exact: grads const, r linear)
                        K[m * mat_stride + idx] += gg * area * rbar;
                        K_flat[m * mat_stride + idx] += gg * area;
                        // r-weighted mass: Σ_c r_c ∫φaφbφc
                        double mrw = 0.0;
                        for (int c = 0; c < 3; ++c) {
                            double coef;
                            if (a == b && b == c) coef = 1.0 / 10.0;
                            else if (a != b && b != c && a != c)
                                coef = 1.0 / 60.0;
                            else coef = 1.0 / 30.0;
                            mrw += py[c] * coef;
                        }
                        M[m * mat_stride + idx] += mrw * area;
                        M_flat[m * mat_stride + idx] +=
                            area * ((a == b) ? 1.0 / 6.0 : 1.0 / 12.0);
                        // gradient-projection rhs: w_a * dφ_b/d{r,z}
                        G_r[idx] += wa * gy[b];
                        G_z[idx] += wa * gx[b];
                    }
                }
            }
        }
    }
}

}  // extern "C"
