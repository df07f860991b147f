// tracking_core: native CV kernels for the visual tracking frontend (C17).
//
// The reference keeps its whole tracking stack native (the ORB-SLAM3 fork);
// here the frontend's orchestration is Python but the per-frame hot kernels
// — Shi-Tomasi corner detection and pyramidal Lucas-Kanade flow — are
// implemented in C++ and exposed over a minimal C ABI (ctypes-friendly,
// no pybind dependency). Everything below is written from the textbook
// formulations (Shi & Tomasi '94; Bouguet's pyramidal LK notes), not ported
// from any library.
//
// A copy of native/tracking_core.cpp for legslam_torch. It is built on the
// host (not with nvcc) by legslam_torch/slam/native.py: compiled with
//   g++ -O3 -march=native -ffast-math -funroll-loops -c -fPIC -std=c++17
// and linked WITHOUT the fast flags (g++ -shared), so crtfastmath.o's
// FTZ/DAZ constructor never runs in the loading process.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Image {
    const float* data;
    int h, w;
    float at(int y, int x) const {
        y = std::min(std::max(y, 0), h - 1);
        x = std::min(std::max(x, 0), w - 1);
        return data[y * w + x];
    }
};

// bilinear sample with border clamp
inline float sample(const Image& im, float y, float x) {
    int x0 = (int)std::floor(x), y0 = (int)std::floor(y);
    float fx = x - x0, fy = y - y0;
    return im.at(y0, x0) * (1 - fx) * (1 - fy) +
           im.at(y0, x0 + 1) * fx * (1 - fy) +
           im.at(y0 + 1, x0) * (1 - fx) * fy +
           im.at(y0 + 1, x0 + 1) * fx * fy;
}

// branch-free bilinear for windows proven interior: identical arithmetic
// to sample() (same expression, same rounding) minus the clamps, so the
// compiler can vectorize the window loops. The klt per-point loops were
// ~0.38 ms/point at win=10 (75 ms/frame at 200 tracks) — almost entirely
// these samples.
inline float sample_fast(const float* row0, const float* row1, float fx,
                         float fy) {
    return row0[0] * (1 - fx) * (1 - fy) + row0[1] * fx * (1 - fy) +
           row1[0] * (1 - fx) * fy + row1[1] * fx * fy;
}

// 3x3 Scharr-style gradients
inline void gradients(const Image& im, std::vector<float>& gx,
                      std::vector<float>& gy) {
    gx.assign((size_t)im.h * im.w, 0.f);
    gy.assign((size_t)im.h * im.w, 0.f);
    for (int y = 0; y < im.h; ++y) {
        for (int x = 0; x < im.w; ++x) {
            gx[(size_t)y * im.w + x] =
                0.5f * (im.at(y, x + 1) - im.at(y, x - 1));
            gy[(size_t)y * im.w + x] =
                0.5f * (im.at(y + 1, x) - im.at(y - 1, x));
        }
    }
}

// separable box blur with radius r (running-sum), in place on src
void box_blur(std::vector<float>& src, int h, int w, int r) {
    std::vector<float> tmp((size_t)h * w);
    const float inv = 1.0f / (2 * r + 1);
    for (int y = 0; y < h; ++y) {
        float acc = 0.f;
        for (int x = -r; x <= r; ++x)
            acc += src[(size_t)y * w + std::min(std::max(x, 0), w - 1)];
        for (int x = 0; x < w; ++x) {
            tmp[(size_t)y * w + x] = acc * inv;
            int xa = std::min(x + r + 1, w - 1);
            int xr = std::max(x - r, 0);
            acc += src[(size_t)y * w + xa] - src[(size_t)y * w + xr];
        }
    }
    for (int x = 0; x < w; ++x) {
        float acc = 0.f;
        for (int y = -r; y <= r; ++y)
            acc += tmp[(size_t)std::min(std::max(y, 0), h - 1) * w + x];
        for (int y = 0; y < h; ++y) {
            src[(size_t)y * w + x] = acc * inv;
            int ya = std::min(y + r + 1, h - 1);
            int yr = std::max(y - r, 0);
            acc += tmp[(size_t)ya * w + x] - tmp[(size_t)yr * w + x];
        }
    }
}

// 2x downsample with 2x2 mean
std::vector<float> downsample(const std::vector<float>& src, int h, int w,
                              int& oh, int& ow) {
    oh = h / 2;
    ow = w / 2;
    std::vector<float> out((size_t)oh * ow);
    for (int y = 0; y < oh; ++y)
        for (int x = 0; x < ow; ++x)
            out[(size_t)y * ow + x] = 0.25f * (
                src[(size_t)(2 * y) * w + 2 * x] +
                src[(size_t)(2 * y) * w + 2 * x + 1] +
                src[(size_t)(2 * y + 1) * w + 2 * x] +
                src[(size_t)(2 * y + 1) * w + 2 * x + 1]);
    return out;
}

}  // namespace

extern "C" {

// Shi-Tomasi corners: min-eigenvalue of the box-integrated structure
// tensor, quality-relative threshold, greedy NMS with a min-distance grid.
// Returns the number of corners written to out_xy ([max_corners * 2]).
int st_detect(const float* gray, int h, int w, int max_corners,
              float quality, int min_distance, float* out_xy) {
    Image im{gray, h, w};
    std::vector<float> gx, gy;
    gradients(im, gx, gy);
    size_t n = (size_t)h * w;
    std::vector<float> ixx(n), iyy(n), ixy(n);
    for (size_t i = 0; i < n; ++i) {
        ixx[i] = gx[i] * gx[i];
        iyy[i] = gy[i] * gy[i];
        ixy[i] = gx[i] * gy[i];
    }
    const int r = 1;
    box_blur(ixx, h, w, r);
    box_blur(iyy, h, w, r);
    box_blur(ixy, h, w, r);
    std::vector<float> score(n, 0.f);
    float max_score = 0.f;
    for (size_t i = 0; i < n; ++i) {
        float tr = 0.5f * (ixx[i] + iyy[i]);
        float det = ixx[i] * iyy[i] - ixy[i] * ixy[i];
        float disc = tr * tr - det;
        float lmin = tr - std::sqrt(std::max(disc, 0.f));
        score[i] = lmin;
        max_score = std::max(max_score, lmin);
    }
    const float th = quality * max_score;
    // candidates above threshold that are 3x3 local maxima
    std::vector<std::pair<float, int>> cands;
    for (int y = 1; y < h - 1; ++y)
        for (int x = 1; x < w - 1; ++x) {
            float s = score[(size_t)y * w + x];
            if (s < th) continue;
            bool peak = true;
            for (int dy = -1; dy <= 1 && peak; ++dy)
                for (int dx = -1; dx <= 1; ++dx)
                    if (score[(size_t)(y + dy) * w + (x + dx)] > s) {
                        peak = false;
                        break;
                    }
            if (peak) cands.emplace_back(s, y * w + x);
        }
    std::sort(cands.begin(), cands.end(),
              [](auto& a, auto& b) { return a.first > b.first; });
    // min-distance suppression on a coarse occupancy grid
    int cell = std::max(min_distance, 1);
    int gh = h / cell + 1, gw = w / cell + 1;
    std::vector<std::vector<std::pair<float, float>>> grid(
        (size_t)gh * gw);
    int count = 0;
    const float md2 = (float)min_distance * (float)min_distance;
    for (auto& [s, idx] : cands) {
        if (count >= max_corners) break;
        float py = (float)(idx / w), px = (float)(idx % w);
        int cy = (int)py / cell, cx = (int)px / cell;
        bool okp = true;
        for (int dy = -1; dy <= 1 && okp; ++dy)
            for (int dx = -1; dx <= 1 && okp; ++dx) {
                int ny = cy + dy, nx = cx + dx;
                if (ny < 0 || ny >= gh || nx < 0 || nx >= gw) continue;
                for (auto& q : grid[(size_t)ny * gw + nx]) {
                    float ddy = q.first - py, ddx = q.second - px;
                    if (ddy * ddy + ddx * ddx < md2) {
                        okp = false;
                        break;
                    }
                }
            }
        if (!okp) continue;
        grid[(size_t)cy * gw + cx].emplace_back(py, px);
        out_xy[2 * count] = px;
        out_xy[2 * count + 1] = py;
        ++count;
    }
    return count;
}

// Pyramidal Lucas-Kanade: track pts ([n*2] x,y) from prev to cur.
// win = half window, levels = pyramid depth, iters per level.
// out_pts [n*2]; status [n] 1=tracked.
//
// The per-point hot path factors every bilinear read through a
// row-blend plane: S(ry, rx) = sample(ly+ry, lx+rx) is built once as
//   By(ry, rx) = (1-fy) * img[by+ry][rx] + fy * img[by+ry+1][rx]
//   S(ry, rx)  = (1-fx) * By(ry, rx)     + fx * By(ry, rx+1)
// (same bilinear value as the old 4-tap form, reassociated), so the
// window loops become contiguous fused-multiply passes the compiler
// vectorizes, and the template/gradient taps are plain subtractions on
// the plane instead of 4 redundant bilinear evaluations per pixel
// (measured ~4x on the 21x21 default window vs the tap-per-pixel form).
void klt_track(const float* prev, const float* cur, int h, int w,
               const float* pts, int n, int levels, int win, int iters,
               float* out_pts, uint8_t* status) {
    // build pyramids
    std::vector<std::vector<float>> pp(levels), cp(levels);
    std::vector<int> ph(levels), pw(levels);
    pp[0].assign(prev, prev + (size_t)h * w);
    cp[0].assign(cur, cur + (size_t)h * w);
    ph[0] = h;
    pw[0] = w;
    for (int l = 1; l < levels; ++l) {
        pp[l] = downsample(pp[l - 1], ph[l - 1], pw[l - 1], ph[l], pw[l]);
        cp[l] = downsample(cp[l - 1], ph[l - 1], pw[l - 1], ph[l], pw[l]);
    }
    const float scale0 = 1.0f / (float)(1 << (levels - 1));
    const int wd = 2 * win + 1;        // window diameter
    const int pd = wd + 2;             // template plane: one-pixel halo
    // per-call scratch, reused across points/levels/iterations
    std::vector<float> tgx((size_t)wd * wd), tgy((size_t)wd * wd),
        tpl((size_t)wd * wd), plane((size_t)pd * (pd + 1)),
        cplane((size_t)wd * (wd + 1));

    // blended plane builder: S[r * (cols+1) + c] = bilinear sample at
    // (y0 + r, x0 + c) for r in [0, rows), c in [0, cols); requires
    // [y0, y0 + rows] x [x0, x0 + cols] in bounds (one extra row/col)
    auto build_plane = [](const Image& im, int y0, int x0, float fx,
                          float fy, int rows, int cols, float* S) {
        const int stride = cols + 1;
        for (int r = 0; r < rows; ++r) {
            const float* r0 = im.data + (size_t)(y0 + r) * im.w + x0;
            const float* r1 = r0 + im.w;
            float* out = S + (size_t)r * stride;
            // y blend into the row buffer (cols+1 wide for the x halo)
            for (int c = 0; c <= cols; ++c)
                out[c] = (1.0f - fy) * r0[c] + fy * r1[c];
        }
        for (int r = 0; r < rows; ++r) {
            float* out = S + (size_t)r * stride;
            for (int c = 0; c < cols; ++c)
                out[c] = (1.0f - fx) * out[c] + fx * out[c + 1];
        }
    };

    for (int i = 0; i < n; ++i) {
        float px = pts[2 * i], py = pts[2 * i + 1];
        float gx_flow = 0.f, gy_flow = 0.f;  // accumulated flow (coarse->fine)
        bool ok = true;
        for (int l = levels - 1; l >= 0; --l) {
            float s = scale0 * (float)(1 << (levels - 1 - l));
            float lx = px * s, ly = py * s;
            Image pim{pp[l].data(), ph[l], pw[l]};
            Image cim{cp[l].data(), ph[l], pw[l]};
            // gradient + template around (lx, ly) in prev level
            float a11 = 0, a12 = 0, a22 = 0;
            int k = 0;
            {
                int bx = (int)std::floor(lx), by = (int)std::floor(ly);
                float fx = lx - bx, fy = ly - by;
                bool interior = bx - win - 1 >= 0 && by - win - 1 >= 0 &&
                                bx + win + 2 < pim.w && by + win + 2 < pim.h;
                if (interior) {
                    // plane rows cover dy in [-win-1, win+1]
                    build_plane(pim, by - win - 1, bx - win - 1, fx, fy,
                                pd, pd, plane.data());
                    const int st = pd + 1;
                    for (int dy = -win; dy <= win; ++dy) {
                        const float* Sm = plane.data() +
                            (size_t)(dy + win) * st + 1;      // row dy-1
                        const float* S0 = Sm + st;            // row dy
                        const float* Sp = S0 + st;            // row dy+1
                        for (int dx = -win; dx <= win; ++dx, ++k) {
                            float ix = 0.5f * (S0[dx + win + 1] -
                                               S0[dx + win - 1]);
                            float iy = 0.5f * (Sp[dx + win] -
                                               Sm[dx + win]);
                            tgx[k] = ix;
                            tgy[k] = iy;
                            tpl[k] = S0[dx + win];
                            a11 += ix * ix;
                            a12 += ix * iy;
                            a22 += iy * iy;
                        }
                    }
                } else {
                    for (int dy = -win; dy <= win; ++dy)
                        for (int dx = -win; dx <= win; ++dx, ++k) {
                            float yy = ly + dy, xx = lx + dx;
                            float ix = 0.5f * (sample(pim, yy, xx + 1) -
                                               sample(pim, yy, xx - 1));
                            float iy = 0.5f * (sample(pim, yy + 1, xx) -
                                               sample(pim, yy - 1, xx));
                            tgx[k] = ix;
                            tgy[k] = iy;
                            tpl[k] = sample(pim, yy, xx);
                            a11 += ix * ix;
                            a12 += ix * iy;
                            a22 += iy * iy;
                        }
                }
            }
            float det = a11 * a22 - a12 * a12;
            if (det < 1e-8f) {
                ok = false;
                break;
            }
            float vx = gx_flow * s, vy = gy_flow * s;
            for (int it = 0; it < iters; ++it) {
                float b1 = 0, b2 = 0;
                k = 0;
                float cx0 = lx + vx, cy0 = ly + vy;
                int cbx = (int)std::floor(cx0), cby = (int)std::floor(cy0);
                float cfx = cx0 - cbx, cfy = cy0 - cby;
                if (cbx - win >= 0 && cby - win >= 0 &&
                    cbx + win + 1 < cim.w && cby + win + 1 < cim.h) {
                    build_plane(cim, cby - win, cbx - win, cfx, cfy,
                                wd, wd, cplane.data());
                    const int st = wd + 1;
                    for (int dy = -win; dy <= win; ++dy) {
                        const float* S0 = cplane.data() +
                            (size_t)(dy + win) * st;
                        const float* tx = tgx.data() + k;
                        const float* ty = tgy.data() + k;
                        const float* tp = tpl.data() + k;
                        for (int dx = 0; dx < wd; ++dx) {
                            float diff = S0[dx] - tp[dx];
                            b1 += diff * tx[dx];
                            b2 += diff * ty[dx];
                        }
                        k += wd;
                    }
                } else {
                    for (int dy = -win; dy <= win; ++dy)
                        for (int dx = -win; dx <= win; ++dx, ++k) {
                            float diff = sample(cim, ly + vy + dy,
                                                lx + vx + dx) - tpl[k];
                            b1 += diff * tgx[k];
                            b2 += diff * tgy[k];
                        }
                }
                float ux = -(a22 * b1 - a12 * b2) / det;
                float uy = -(-a12 * b1 + a11 * b2) / det;
                vx += ux;
                vy += uy;
                if (ux * ux + uy * uy < 1e-6f) break;
            }
            gx_flow = vx / s;
            gy_flow = vy / s;
        }
        float nx = px + gx_flow, ny = py + gy_flow;
        if (!ok || nx < 0 || ny < 0 || nx > (float)(w - 1) ||
            ny > (float)(h - 1)) {
            status[i] = 0;
            out_pts[2 * i] = px;
            out_pts[2 * i + 1] = py;
        } else {
            status[i] = 1;
            out_pts[2 * i] = nx;
            out_pts[2 * i + 1] = ny;
        }
    }
}

}  // extern "C"
