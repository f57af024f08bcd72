// Native direction-field baker.
//
// Host fast path of torchdrivesim_tpu_torch.map_grids._bake_direction
// (counterpart of the reference's torchdrivesim_tpu/native/mapbake.cpp):
// rasterize each lanelet's footprint (dilated by `tolerance`) onto the map
// grid and write the direction of the nearest centerline segment into the
// first free of K per-cell layers. It replaces the numpy per-lanelet loop,
// whose (cells x edges) temporaries made large rural maps bake in minutes.
//
// Semantics mirror the Python baker (map_grids.py _bake_direction,
// _points_near_polygon, _polyline_directions_at):
//  * coverage = even-odd point-in-polygon OR within `tolerance` of any
//    boundary segment (clamped-projection distance);
//  * direction = atan2 of the nearest centerline segment (first argmin on
//    ties), stored through a float32 cos/sin round trip like the Python
//    arrays, quantized to 254 bins over [-pi, pi); 255 marks an empty layer;
//  * lanelets processed in layer order; each covered cell takes the next
//    free layer slot, extra overlaps beyond K are dropped.
//
// Built on first use by torchdrivesim_tpu_torch/native/__init__.py with the
// system g++ into build/native/; the Python baker is the fallback.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline double seg_dist_sq(double px, double py, double ax, double ay,
                          double bx, double by) {
    const double abx = bx - ax, aby = by - ay;
    const double l2 = abx * abx + aby * aby;
    double t = ((px - ax) * abx + (py - ay) * aby) / (l2 > 1e-12 ? l2 : 1e-12);
    t = t < 0.0 ? 0.0 : (t > 1.0 ? 1.0 : t);
    const double qx = ax + t * abx - px, qy = ay + t * aby - py;
    return qx * qx + qy * qy;
}

}  // namespace

extern "C" int tds_bake_direction(
    const double* poly_pts,   // concatenated (x, y) boundary vertices
    const int64_t* poly_off,  // n_ll + 1 offsets (in points) into poly_pts
    const double* cl_pts,     // concatenated (x, y) centerline vertices
    const int64_t* cl_off,    // n_ll + 1 offsets (in points) into cl_pts
    int64_t n_ll,
    double origin_x, double origin_y, double cell,
    int64_t h, int64_t w, double tolerance, int64_t k_layers,
    int32_t* out_packed /* h * w, byte k = layer k, 255 = invalid */) {
    if (k_layers <= 0 || k_layers > 4 || h <= 0 || w <= 0) return 1;

    std::vector<uint8_t> q(static_cast<size_t>(h) * w * k_layers, 255);
    std::vector<uint8_t> count(static_cast<size_t>(h) * w, 0);
    const double tol2 = tolerance * tolerance;

    for (int64_t li = 0; li < n_ll; ++li) {
        const double* poly = poly_pts + 2 * poly_off[li];
        const int64_t np_ = poly_off[li + 1] - poly_off[li];
        const double* cl = cl_pts + 2 * cl_off[li];
        const int64_t nc = cl_off[li + 1] - cl_off[li];
        if (np_ < 3 || nc < 2) continue;

        double minx = poly[0], maxx = poly[0], miny = poly[1], maxy = poly[1];
        for (int64_t i = 1; i < np_; ++i) {
            minx = std::min(minx, poly[2 * i]);
            maxx = std::max(maxx, poly[2 * i]);
            miny = std::min(miny, poly[2 * i + 1]);
            maxy = std::max(maxy, poly[2 * i + 1]);
        }
        // same bbox->index rounding as the Python baker
        int64_t x0 = (int64_t)std::floor((minx - origin_x - tolerance) / cell);
        int64_t y0 = (int64_t)std::floor((miny - origin_y - tolerance) / cell);
        int64_t x1 = (int64_t)std::ceil((maxx - origin_x + tolerance) / cell) + 1;
        int64_t y1 = (int64_t)std::ceil((maxy - origin_y + tolerance) / cell) + 1;
        x0 = std::max<int64_t>(x0, 0); y0 = std::max<int64_t>(y0, 0);
        x1 = std::min(x1, w); y1 = std::min(y1, h);
        if (x0 >= x1 || y0 >= y1) continue;

        for (int64_t iy = y0; iy < y1; ++iy) {
            const double py = origin_y + iy * cell;
            for (int64_t ix = x0; ix < x1; ++ix) {
                const double px = origin_x + ix * cell;

                // even-odd crossing test over all boundary edges
                bool inside = false;
                double best = 1e30;  // squared distance to the boundary
                for (int64_t e = 0; e < np_; ++e) {
                    const int64_t f = (e + 1 == np_) ? 0 : e + 1;
                    const double ax = poly[2 * e], ay = poly[2 * e + 1];
                    const double bx = poly[2 * f], by = poly[2 * f + 1];
                    if ((ay > py) != (by > py)) {
                        const double xc =
                            (bx - ax) * (py - ay) / (by - ay) + ax;
                        if (px < xc) inside = !inside;
                    }
                    const double d2 = seg_dist_sq(px, py, ax, ay, bx, by);
                    if (d2 < best) best = d2;
                }
                if (!inside && best > tol2) continue;

                const size_t cell_idx = static_cast<size_t>(iy) * w + ix;
                const uint8_t slot = count[cell_idx];
                if (slot >= k_layers) continue;  // layers full: drop overlap
                count[cell_idx] = slot + 1;

                // nearest centerline segment (first argmin on ties)
                double bd = 1e30;
                int64_t seg = 0;
                for (int64_t s = 0; s + 1 < nc; ++s) {
                    const double d2 = seg_dist_sq(
                        px, py, cl[2 * s], cl[2 * s + 1],
                        cl[2 * s + 2], cl[2 * s + 3]);
                    if (d2 < bd) { bd = d2; seg = s; }
                }
                const double dx = cl[2 * seg + 2] - cl[2 * seg];
                const double dy = cl[2 * seg + 3] - cl[2 * seg + 1];
                const double dir = std::atan2(dy, dx);
                // float32 cos/sin round trip, matching the numpy arrays
                const float cf = (float)std::cos(dir);
                const float sf = (float)std::sin(dir);
                const double ang = (double)std::atan2(sf, cf);
                // numpy rounds half to even; C lround rounds half away from
                // zero -- halfway hits are measure-zero on real geometry
                long qv = std::lround((ang + M_PI) / (2.0 * M_PI) * 254.0);
                qv = qv < 0 ? 0 : (qv > 254 ? 254 : qv);
                q[cell_idx * k_layers + slot] = (uint8_t)qv;
            }
        }
    }

    for (int64_t i = 0; i < h * w; ++i) {
        uint32_t packed = 0;
        for (int64_t k = 0; k < k_layers; ++k) {
            packed |= (uint32_t)q[static_cast<size_t>(i) * k_layers + k]
                      << (8 * k);
        }
        out_packed[i] = (int32_t)packed;
    }
    return 0;
}
