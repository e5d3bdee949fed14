// Native morphology kernels for XAI region post-processing.
//
// The reference's region cleanup runs scipy.ndimage's C implementations
// (binary_closing/opening, label, component sizes —
// `xai/XAI.py:1388-1409`). This is the framework's own native runtime
// equivalent: a dependency-free C++ implementation with identical
// semantics (3x3 structuring element, connectivity 1 or 2, zero border),
// loaded through ctypes (`synt_isic_tpu_torch/native/__init__.py`, which
// builds it into `synt_isic_tpu_torch/_build/` at first use), with scipy
// kept as a fallback. Exact behavioral parity is enforced by
// tests/test_torch_xai.py against scipy on random masks.
//
// Build: g++ -O2 -shared -fPIC -o libmorphology.so morphology.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// structuring element offsets: connectivity 1 = cross, 2 = full 3x3
static const int CROSS[5][2] = {{0, 0}, {-1, 0}, {1, 0}, {0, -1}, {0, 1}};
static const int FULL[9][2] = {{0, 0},  {-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
                               {0, 1},  {1, -1},  {1, 0},  {1, 1}};

inline const int (*structure(int connectivity, int *n))[2] {
    if (connectivity == 1) {
        *n = 5;
        return CROSS;
    }
    *n = 9;
    return FULL;
}

void dilate_once(const uint8_t *in, uint8_t *out, int h, int w,
                 const int (*se)[2], int n_se) {
    std::memset(out, 0, (size_t)h * w);
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            if (!in[y * w + x]) continue;
            for (int k = 0; k < n_se; ++k) {
                int yy = y + se[k][0], xx = x + se[k][1];
                if (yy >= 0 && yy < h && xx >= 0 && xx < w)
                    out[yy * w + xx] = 1;
            }
        }
    }
}

void erode_once(const uint8_t *in, uint8_t *out, int h, int w,
                const int (*se)[2], int n_se) {
    // zero border: pixels whose neighborhood leaves the image are eroded
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            uint8_t keep = 1;
            for (int k = 0; k < n_se && keep; ++k) {
                int yy = y + se[k][0], xx = x + se[k][1];
                if (yy < 0 || yy >= h || xx < 0 || xx >= w ||
                    !in[yy * w + xx])
                    keep = 0;
            }
            out[y * w + x] = keep;
        }
    }
}

void repeat(void (*op)(const uint8_t *, uint8_t *, int, int,
                       const int (*)[2], int),
            const uint8_t *in, uint8_t *out, int h, int w, int connectivity,
            int iterations) {
    int n_se;
    const int(*se)[2] = structure(connectivity, &n_se);
    std::vector<uint8_t> a(in, in + (size_t)h * w), b((size_t)h * w);
    for (int i = 0; i < iterations; ++i) {
        op(a.data(), b.data(), h, w, se, n_se);
        a.swap(b);
    }
    std::memcpy(out, a.data(), (size_t)h * w);
}

}  // namespace

extern "C" {

void morph_dilate(const uint8_t *in, uint8_t *out, int h, int w,
                  int connectivity, int iterations) {
    repeat(dilate_once, in, out, h, w, connectivity, iterations);
}

void morph_erode(const uint8_t *in, uint8_t *out, int h, int w,
                 int connectivity, int iterations) {
    repeat(erode_once, in, out, h, w, connectivity, iterations);
}

void morph_closing(const uint8_t *in, uint8_t *out, int h, int w,
                   int connectivity, int iterations) {
    std::vector<uint8_t> tmp((size_t)h * w);
    repeat(dilate_once, in, tmp.data(), h, w, connectivity, iterations);
    repeat(erode_once, tmp.data(), out, h, w, connectivity, iterations);
}

void morph_opening(const uint8_t *in, uint8_t *out, int h, int w,
                   int connectivity, int iterations) {
    std::vector<uint8_t> tmp((size_t)h * w);
    repeat(erode_once, in, tmp.data(), h, w, connectivity, iterations);
    repeat(dilate_once, tmp.data(), out, h, w, connectivity, iterations);
}

// connected-component labeling (scipy.ndimage.label semantics: labels
// assigned in raster-scan order starting at 1). Returns the label count.
int morph_label(const uint8_t *in, int32_t *labels, int h, int w,
                int connectivity) {
    int n_se;
    const int(*se)[2] = structure(connectivity, &n_se);
    std::memset(labels, 0, (size_t)h * w * sizeof(int32_t));
    std::vector<int> stack;
    int next = 0;
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            int idx = y * w + x;
            if (!in[idx] || labels[idx]) continue;
            ++next;
            labels[idx] = next;
            stack.push_back(idx);
            while (!stack.empty()) {
                int cur = stack.back();
                stack.pop_back();
                int cy = cur / w, cx = cur % w;
                for (int k = 0; k < n_se; ++k) {
                    int yy = cy + se[k][0], xx = cx + se[k][1];
                    if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
                    int nidx = yy * w + xx;
                    if (in[nidx] && !labels[nidx]) {
                        labels[nidx] = next;
                        stack.push_back(nidx);
                    }
                }
            }
        }
    }
    return next;
}

// drop components smaller than min_size, in place
void morph_remove_small(uint8_t *mask, int h, int w, int connectivity,
                        int min_size) {
    std::vector<int32_t> labels((size_t)h * w);
    int n = morph_label(mask, labels.data(), h, w, connectivity);
    if (n == 0) return;
    std::vector<int> sizes(n + 1, 0);
    for (int i = 0; i < h * w; ++i) sizes[labels[i]]++;
    for (int i = 0; i < h * w; ++i)
        if (labels[i] && sizes[labels[i]] < min_size) mask[i] = 0;
}

}  // extern "C"
