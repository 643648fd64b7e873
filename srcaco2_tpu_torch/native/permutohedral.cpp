// The port's own copy of srcaco2_tpu/native/permutohedral.cpp (the port
// imports nothing of the JAX package); built by native/__init__.py.
//
// Permutohedral-lattice high-dimensional Gaussian filtering.
//
// Native analog of the reference's SWIG module
// (dlib/crf/crfwrapper/bilateralfilter: permutohedral.cpp + ,
// bilateralfilter.cpp, built by create_env.sh:23-25), implemented from
// the published algorithm (Adams, Baek, Davis, "Fast High-Dimensional
// Filtering Using the Permutohedral Lattice", Eurographics 2010):
// embed features into the (d+1)-dim hyperplane sum(x)=0, find the
// enclosing simplex by differential sorting, splat with barycentric
// weights into a hashed sparse lattice, blur along each lattice
// direction with a [1,2,1] kernel, slice back.
//
// Exposed C API (ctypes-friendly; layout matches the reference's
// bilateralfilter_batch usage in dense_crf_loss.py:26):
//   bilateralfilter_batch(images, seg, out, N, K, H, W, sigma_rgb,
//                         sigma_xy)  -- images (N,3,H,W), seg (N,K,H,W)
//   permutohedral_filter(features, values, out, n, d, vd)
//   bilateral_grey_batch(...)        -- 1-channel image variant.
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <unordered_map>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct KeyHash {
    size_t operator()(const std::vector<int16_t>& k) const {
        size_t h = 14695981039346656037ull;
        for (int16_t v : k) {
            h ^= static_cast<size_t>(static_cast<uint16_t>(v));
            h *= 1099511628211ull;
        }
        return h;
    }
};

class PermutohedralLattice {
  public:
    PermutohedralLattice(int d, int vd, int n)
        : d_(d), vd_(vd), n_(n) {
        offsets_.assign(static_cast<size_t>(n_) * (d_ + 1), 0);
        weights_.assign(static_cast<size_t>(n_) * (d_ + 1), 0.f);
        table_.reserve(static_cast<size_t>(n_) * (d_ + 1));
        // E-matrix scale factors for the embedding.
        scale_.resize(d_);
        for (int i = 0; i < d_; ++i) {
            scale_[i] = 1.0f / std::sqrt(
                static_cast<float>((i + 1) * (i + 2)));
        }
        inv_std_ = std::sqrt(2.0f / 3.0f) * (d_ + 1);
    }

    // Compute simplex membership and weights for every input point.
    void splat_setup(const float* features) {
        std::vector<float> elevated(d_ + 1);
        std::vector<float> rem0(d_ + 1);
        std::vector<int> rank(d_ + 1);
        std::vector<float> bary(d_ + 2);
        std::vector<int16_t> key(d_);

        for (int p = 0; p < n_; ++p) {
            const float* f = features + static_cast<size_t>(p) * d_;
            // embed: E * f, computed with the O(d) recurrence.
            float sm = 0.f;
            for (int j = d_; j > 0; --j) {
                float cf = f[j - 1] * scale_[j - 1] * inv_std_;
                elevated[j] = sm - j * cf;
                sm += cf;
            }
            elevated[0] = sm;

            // nearest remainder-0 lattice point.
            int sum = 0;
            const float down = 1.0f / (d_ + 1);
            for (int i = 0; i <= d_; ++i) {
                float v = elevated[i] * down;
                float up = std::ceil(v) * (d_ + 1);
                float dn = std::floor(v) * (d_ + 1);
                rem0[i] = (up - elevated[i] < elevated[i] - dn) ? up : dn;
                sum += static_cast<int>(rem0[i]) / (d_ + 1);
            }

            // rank differential coordinates.
            for (int i = 0; i <= d_; ++i) rank[i] = 0;
            for (int i = 0; i < d_; ++i) {
                double di = elevated[i] - rem0[i];
                for (int j = i + 1; j <= d_; ++j) {
                    if (di < elevated[j] - rem0[j]) ++rank[i];
                    else ++rank[j];
                }
            }
            // fix points outside the canonical simplex.
            for (int i = 0; i <= d_; ++i) {
                rank[i] += sum;
                if (rank[i] < 0) {
                    rank[i] += d_ + 1;
                    rem0[i] += d_ + 1;
                } else if (rank[i] > d_) {
                    rank[i] -= d_ + 1;
                    rem0[i] -= d_ + 1;
                }
            }

            // barycentric coordinates.
            for (int i = 0; i <= d_ + 1; ++i) bary[i] = 0.f;
            for (int i = 0; i <= d_; ++i) {
                float delta = (elevated[i] - rem0[i]) * down;
                bary[d_ - rank[i]] += delta;
                bary[d_ + 1 - rank[i]] -= delta;
            }
            bary[0] += 1.0f + bary[d_ + 1];

            // register the d+1 simplex vertices in the hash table.
            for (int remainder = 0; remainder <= d_; ++remainder) {
                for (int i = 0; i < d_; ++i) {
                    int16_t ki = static_cast<int16_t>(
                        rem0[i] + remainder);
                    if (rank[i] > d_ - remainder)
                        ki -= static_cast<int16_t>(d_ + 1);
                    key[i] = ki;
                }
                auto it = table_.find(key);
                int idx;
                if (it == table_.end()) {
                    idx = static_cast<int>(table_.size());
                    table_.emplace(key, idx);
                } else {
                    idx = it->second;
                }
                offsets_[static_cast<size_t>(p) * (d_ + 1) + remainder]
                    = idx;
                weights_[static_cast<size_t>(p) * (d_ + 1) + remainder]
                    = bary[remainder];
            }
        }
        m_ = static_cast<int>(table_.size());
        // neighbor indices along each lattice direction for the blur.
        blur_n1_.assign(static_cast<size_t>(m_) * (d_ + 1), -1);
        blur_n2_.assign(static_cast<size_t>(m_) * (d_ + 1), -1);
        std::vector<int16_t> np(d_), nm(d_);
        for (const auto& kv : table_) {
            const auto& k = kv.first;
            int idx = kv.second;
            for (int j = 0; j <= d_; ++j) {
                for (int i = 0; i < d_; ++i) {
                    np[i] = static_cast<int16_t>(k[i] + 1);
                    nm[i] = static_cast<int16_t>(k[i] - 1);
                }
                if (j < d_) {
                    np[j] = static_cast<int16_t>(k[j] - d_);
                    nm[j] = static_cast<int16_t>(k[j] + d_);
                }
                auto itp = table_.find(np);
                auto itm = table_.find(nm);
                blur_n1_[static_cast<size_t>(idx) * (d_ + 1) + j] =
                    itm == table_.end() ? -1 : itm->second;
                blur_n2_[static_cast<size_t>(idx) * (d_ + 1) + j] =
                    itp == table_.end() ? -1 : itp->second;
            }
        }
    }

    // Filter `values` (n x vd) -> out (n x vd).
    void filter(const float* values, float* out) const {
        std::vector<float> lat(static_cast<size_t>(m_) * vd_, 0.f);
        // splat
        for (int p = 0; p < n_; ++p) {
            for (int r = 0; r <= d_; ++r) {
                int idx = offsets_[static_cast<size_t>(p) * (d_ + 1) + r];
                float w = weights_[static_cast<size_t>(p)
                                   * (d_ + 1) + r];
                const float* v = values + static_cast<size_t>(p) * vd_;
                float* l = lat.data() + static_cast<size_t>(idx) * vd_;
                for (int c = 0; c < vd_; ++c) l[c] += w * v[c];
            }
        }
        // blur along each direction with [1, 2, 1] / 2.
        std::vector<float> nxt(lat.size());
        for (int j = 0; j <= d_; ++j) {
            for (int idx = 0; idx < m_; ++idx) {
                int i1 = blur_n1_[static_cast<size_t>(idx)
                                  * (d_ + 1) + j];
                int i2 = blur_n2_[static_cast<size_t>(idx)
                                  * (d_ + 1) + j];
                const float* c0 = lat.data()
                    + static_cast<size_t>(idx) * vd_;
                const float* c1 = i1 >= 0 ? lat.data()
                    + static_cast<size_t>(i1) * vd_ : nullptr;
                const float* c2 = i2 >= 0 ? lat.data()
                    + static_cast<size_t>(i2) * vd_ : nullptr;
                float* o = nxt.data() + static_cast<size_t>(idx) * vd_;
                for (int c = 0; c < vd_; ++c) {
                    float acc = c0[c] * 2.f;
                    if (c1) acc += c1[c];
                    if (c2) acc += c2[c];
                    o[c] = acc * 0.5f;
                }
            }
            lat.swap(nxt);
        }
        // slice (with the standard alpha normalization).
        const float alpha = 1.0f / (1.0f + std::pow(2.0f, -d_));
        for (int p = 0; p < n_; ++p) {
            float* o = out + static_cast<size_t>(p) * vd_;
            for (int c = 0; c < vd_; ++c) o[c] = 0.f;
            for (int r = 0; r <= d_; ++r) {
                int idx = offsets_[static_cast<size_t>(p) * (d_ + 1) + r];
                float w = weights_[static_cast<size_t>(p)
                                   * (d_ + 1) + r];
                const float* l = lat.data()
                    + static_cast<size_t>(idx) * vd_;
                for (int c = 0; c < vd_; ++c) o[c] += w * l[c] * alpha;
            }
        }
    }

  private:
    int d_, vd_, n_, m_ = 0;
    float inv_std_;
    std::vector<float> scale_;
    std::vector<int> offsets_;
    std::vector<float> weights_;
    std::vector<int> blur_n1_, blur_n2_;
    std::unordered_map<std::vector<int16_t>, int, KeyHash> table_;
};

void bilateral_one(const float* img, int img_c, const float* seg,
                   float* out, int K, int H, int W, float sigma_rgb,
                   float sigma_xy) {
    const int n = H * W;
    const int d = 2 + img_c;
    std::vector<float> feats(static_cast<size_t>(n) * d);
    for (int y = 0; y < H; ++y) {
        for (int x = 0; x < W; ++x) {
            float* f = feats.data()
                + (static_cast<size_t>(y) * W + x) * d;
            f[0] = x / sigma_xy;
            f[1] = y / sigma_xy;
            for (int c = 0; c < img_c; ++c) {
                f[2 + c] = img[static_cast<size_t>(c) * n
                               + y * W + x] / sigma_rgb;
            }
        }
    }
    PermutohedralLattice lattice(d, K, n);
    lattice.splat_setup(feats.data());
    // values: (n, K) from seg (K, H, W)
    std::vector<float> vals(static_cast<size_t>(n) * K);
    for (int k = 0; k < K; ++k)
        for (int p = 0; p < n; ++p)
            vals[static_cast<size_t>(p) * K + k] =
                seg[static_cast<size_t>(k) * n + p];
    std::vector<float> res(vals.size());
    lattice.filter(vals.data(), res.data());
    for (int k = 0; k < K; ++k)
        for (int p = 0; p < n; ++p)
            out[static_cast<size_t>(k) * n + p] =
                res[static_cast<size_t>(p) * K + k];
}

}  // namespace

extern "C" {

// Reference-compatible API: images (N,3,H,W) flattened, seg (N,K,H,W)
// flattened, out same shape as seg.
void bilateralfilter_batch(const float* images, const float* seg,
                           float* out, int N, int K, int H, int W,
                           float sigma_rgb, float sigma_xy) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int i = 0; i < N; ++i) {
        bilateral_one(images + static_cast<size_t>(i) * 3 * H * W, 3,
                      seg + static_cast<size_t>(i) * K * H * W,
                      out + static_cast<size_t>(i) * K * H * W,
                      K, H, W, sigma_rgb, sigma_xy);
    }
}

// Grayscale variant (the caco2 data is 1-channel).
void bilateral_grey_batch(const float* images, const float* seg,
                          float* out, int N, int K, int H, int W,
                          float sigma_rgb, float sigma_xy) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int i = 0; i < N; ++i) {
        bilateral_one(images + static_cast<size_t>(i) * H * W, 1,
                      seg + static_cast<size_t>(i) * K * H * W,
                      out + static_cast<size_t>(i) * K * H * W,
                      K, H, W, sigma_rgb, sigma_xy);
    }
}

// Generic lattice filter: features (n, d), values (n, vd).
void permutohedral_filter(const float* features, const float* values,
                          float* out, int n, int d, int vd) {
    PermutohedralLattice lattice(d, vd, n);
    lattice.splat_setup(features);
    lattice.filter(values, out);
}

}  // extern "C"
