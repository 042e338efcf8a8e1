// Native control-map renderer: windowed separable Gaussian blobs.
//
// The host-side input pipeline renders (F, H, W, 3) force/mass control videos
// (81x480x832 ~= 97M floats per sample). The Gaussian exp(-d^2/2r^2) factorizes into an
// outer product of 1-D exponentials and is numerically zero beyond ~7 radii, so each blob
// only touches a (2*window)^2 patch. Exposed via ctypes (build: goal_force_tpu_torch/native).
//
// A copy of goal_force_tpu/native/control_render.cpp: the two must stay equal, so that both
// packages render the same bits (tests/test_torch_control_native.py). Behavioral contract:
// goal_force_tpu_torch/data/control_signal.py.

#include <cmath>
#include <cstdint>
#include <algorithm>

namespace {

inline int clampi(int v, int lo, int hi) { return std::max(lo, std::min(v, hi)); }

// Add one blob at (cx, cy) radius r into channel `c` of frame plane `frame`.
void add_blob_frame(float* out, int H, int W, int C, int c, int64_t frame_off,
                    float cx, float cy, float r, float amplitude) {
    const float inv = 1.0f / (2.0f * r * r);
    const int win = static_cast<int>(std::ceil(7.0f * r));
    const int x0 = clampi(static_cast<int>(std::floor(cx)) - win, 0, W);
    const int x1 = clampi(static_cast<int>(std::ceil(cx)) + win + 1, 0, W);
    const int y0 = clampi(static_cast<int>(std::floor(cy)) - win, 0, H);
    const int y1 = clampi(static_cast<int>(std::ceil(cy)) + win + 1, 0, H);
    if (x0 >= x1 || y0 >= y1) return;

    float gx[4096];
    const int nx = x1 - x0;
    for (int i = 0; i < nx; ++i) {
        const float dx = static_cast<float>(x0 + i) - cx;
        gx[i] = std::exp(-dx * dx * inv);
    }
    for (int y = y0; y < y1; ++y) {
        const float dy = static_cast<float>(y) - cy;
        const float gy = amplitude * std::exp(-dy * dy * inv);
        float* row = out + frame_off + (static_cast<int64_t>(y) * W + x0) * C + c;
        for (int i = 0; i < nx; ++i) {
            row[static_cast<int64_t>(i) * C] += gy * gx[i];
        }
    }
}

}  // namespace

extern "C" {

// Moving blob: per-frame centers xs[f], ys[f]; adds into channel c of (F,H,W,C) out.
void gf_add_moving_blob(float* out, int F, int H, int W, int C, int c,
                        const float* xs, const float* ys, float radius, float amplitude) {
    const int64_t plane = static_cast<int64_t>(H) * W * C;
    for (int f = 0; f < F; ++f) {
        add_blob_frame(out, H, W, C, c, f * plane, xs[f], ys[f], radius, amplitude);
    }
}

// Static blobs: n blobs (same every frame) added into channel c of every frame.
void gf_add_static_blobs(float* out, int F, int H, int W, int C, int c,
                         const float* xs, const float* ys, const float* radii, int n,
                         float amplitude) {
    const int64_t plane = static_cast<int64_t>(H) * W * C;
    for (int f = 0; f < F; ++f) {
        for (int i = 0; i < n; ++i) {
            add_blob_frame(out, H, W, C, c, f * plane, xs[i], ys[i], radii[i], amplitude);
        }
    }
}

// In-place clamp to [0, 1].
void gf_clamp01(float* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = std::min(1.0f, std::max(0.0f, out[i]));
    }
}

}  // extern "C"
