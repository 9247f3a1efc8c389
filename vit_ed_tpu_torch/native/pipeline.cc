// Native input-pipeline runtime of vit_ed_tpu_torch (its own copy of the
// JAX package's runtime, the same functions): crop -> resample -> normalize,
// colour jitter, the affine warp, Gaussian blur, JPEG decode and a
// persistent worker pool that prepares whole batches off the Python thread.
//
// The pool takes the place of DataLoader worker processes: instead of
// pickling samples across process boundaries, image preparation runs in
// C++ threads that share the batch output buffer with numpy (zero copies,
// GIL released for the whole batch).
//
// Resampling reimplements the standard separable-convolution scheme that
// Pillow uses (triangle / Catmull-Rom kernels evaluated in 22-bit fixed
// point), so outputs are BIT-EXACT against PIL's Image.resize for both
// BILINEAR and BICUBIC on uint8 images (tests/test_torch_native_pipeline.py).
// Grayscale conversion matches PIL "L"
// (ITU-R 601-2: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16).
//
// Normalization is the fused single pass for
//   (np.asarray(img, float32) / 255.0 - mean) / std
// with identical f32 op order, so it is bit-exact vs the numpy chain in
// data/transforms.py (to_tensor + normalize) while touching memory once.
//
// Bit-exactness depends on the build flags (native/pipeline.py): no
// -ffast-math, and -ffp-contract=off so that no implicit fma is formed.

#include <atomic>
#include <cmath>

#if defined(__SSE4_1__)
#include <immintrin.h>
#include <smmintrin.h>
#endif
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

// JPEG decode via the system libjpeg (the SAME library PIL links, with the
// same defaults — JDCT_ISLOW, fancy upsampling — so outputs are bit-exact
// vs PIL.Image.open(...).convert("RGB") for baseline/progressive JPEGs;
// verified in tests/test_torch_native_pipeline.py). Compiled out when jpeglib is
// unavailable (-DVT_NO_JPEG fallback build).
#if !defined(VT_NO_JPEG) && __has_include(<jpeglib.h>)
#define VT_HAVE_JPEG 1
#include <jpeglib.h>
#else
#define VT_HAVE_JPEG 0
#endif

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow's 8bpc fixed point

inline uint8_t clip8(int in) {
  if (in >= (1 << (kPrecisionBits + 8))) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

struct Filter {
  double (*fn)(double);
  double support;
};

double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

double bicubic_filter(double x) {
  // Catmull-Rom spline, a = -0.5 (Pillow's BICUBIC)
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

const Filter kBilinear = {bilinear_filter, 1.0};
const Filter kBicubic = {bicubic_filter, 2.0};

// Coefficients for one resampled axis: for each output position, the input
// window [bounds[2i], bounds[2i]+bounds[2i+1]) and ksize fixed-point weights.
int precompute_coeffs(int in_size, int out_size, const Filter& filter,
                      std::vector<int>& bounds, std::vector<int>& kk) {
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = filter.support * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds.assign(out_size * 2, 0);
  std::vector<double> w(out_size * ksize, 0.0);
  double ss = 1.0 / filterscale;
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &w[xx * ksize];
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      double v = filter.fn((x + xmin - center + 0.5) * ss);
      k[x] = v;
      ww += v;
    }
    if (ww != 0.0) {
      for (int x = 0; x < xmax; ++x) k[x] /= ww;
    }
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  kk.assign(out_size * ksize, 0);
  for (size_t i = 0; i < w.size(); ++i) {
    kk[i] = w[i] < 0.0
                ? static_cast<int>(-0.5 + w[i] * (1 << kPrecisionBits))
                : static_cast<int>(0.5 + w[i] * (1 << kPrecisionBits));
  }
  return ksize;
}

// Horizontal pass: [h, w_in, c] u8 -> [h, w_out, c] u8 (row stride given so
// the source can be a crop view into a larger image).
void resample_horizontal(const uint8_t* src, int64_t src_stride, int h,
                         int w_out, int c, const std::vector<int>& bounds,
                         const std::vector<int>& kk, int ksize, uint8_t* dst) {
  for (int yy = 0; yy < h; ++yy) {
    const uint8_t* row = src + yy * src_stride;
    uint8_t* orow = dst + static_cast<int64_t>(yy) * w_out * c;
    for (int xx = 0; xx < w_out; ++xx) {
      int xmin = bounds[xx * 2];
      int xmax = bounds[xx * 2 + 1];
      const int* k = &kk[xx * ksize];
      for (int ch = 0; ch < c; ++ch) {
        int ss = 1 << (kPrecisionBits - 1);
        const uint8_t* p = row + static_cast<int64_t>(xmin) * c + ch;
        for (int x = 0; x < xmax; ++x) ss += p[static_cast<int64_t>(x) * c] * k[x];
        orow[xx * c + ch] = clip8(ss);
      }
    }
  }
}

// Vertical pass: [h_in, w, c] u8 (contiguous) -> [h_out, w, c] u8.
void resample_vertical(const uint8_t* src, int w, int h_out, int c,
                       const std::vector<int>& bounds, const std::vector<int>& kk,
                       int ksize, uint8_t* dst) {
  int64_t row = static_cast<int64_t>(w) * c;
  for (int yy = 0; yy < h_out; ++yy) {
    int ymin = bounds[yy * 2];
    int ymax = bounds[yy * 2 + 1];
    const int* k = &kk[yy * ksize];
    uint8_t* orow = dst + yy * row;
    for (int64_t i = 0; i < row; ++i) {
      int ss = 1 << (kPrecisionBits - 1);
      const uint8_t* p = src + ymin * row + i;
      for (int y = 0; y < ymax; ++y) ss += p[y * row] * k[y];
      orow[i] = clip8(ss);
    }
  }
}

// Full resample of a crop view: src[y0:y0+ch_, x0:x0+cw_] -> dst [oh, ow, c].
// Returns 0 on success.
int resample(const uint8_t* src, int h, int w, int c, int y0, int x0, int ch_,
             int cw_, uint8_t* dst, int oh, int ow, const Filter& filter) {
  if (y0 < 0 || x0 < 0 || ch_ <= 0 || cw_ <= 0 || y0 + ch_ > h || x0 + cw_ > w)
    return 1;
  if (oh <= 0 || ow <= 0 || c <= 0) return 1;
  const uint8_t* view = src + (static_cast<int64_t>(y0) * w + x0) * c;
  int64_t stride = static_cast<int64_t>(w) * c;

  if (cw_ == ow && ch_ == oh) {  // pure crop
    for (int yy = 0; yy < oh; ++yy)
      std::memcpy(dst + static_cast<int64_t>(yy) * ow * c, view + yy * stride,
                  static_cast<size_t>(ow) * c);
    return 0;
  }

  std::vector<int> bounds, kk;
  if (cw_ != ow && ch_ != oh) {
    // horizontal into temp (full crop height), then vertical
    std::vector<uint8_t> tmp(static_cast<size_t>(ch_) * ow * c);
    int ks = precompute_coeffs(cw_, ow, filter, bounds, kk);
    resample_horizontal(view, stride, ch_, ow, c, bounds, kk, ks, tmp.data());
    ks = precompute_coeffs(ch_, oh, filter, bounds, kk);
    resample_vertical(tmp.data(), ow, oh, c, bounds, kk, ks, dst);
  } else if (cw_ != ow) {
    int ks = precompute_coeffs(cw_, ow, filter, bounds, kk);
    resample_horizontal(view, stride, ch_, ow, c, bounds, kk, ks, dst);
  } else {
    // vertical only; source view may be strided — copy rows if needed
    if (stride == static_cast<int64_t>(cw_) * c) {
      int ks = precompute_coeffs(ch_, oh, filter, bounds, kk);
      resample_vertical(view, cw_, oh, c, bounds, kk, ks, dst);
    } else {
      std::vector<uint8_t> tmp(static_cast<size_t>(ch_) * cw_ * c);
      for (int yy = 0; yy < ch_; ++yy)
        std::memcpy(tmp.data() + static_cast<int64_t>(yy) * cw_ * c,
                    view + yy * stride, static_cast<size_t>(cw_) * c);
      int ks = precompute_coeffs(ch_, oh, filter, bounds, kk);
      resample_vertical(tmp.data(), cw_, oh, c, bounds, kk, ks, dst);
    }
  }
  return 0;
}

const Filter& filter_by_id(int id) { return id == 1 ? kBicubic : kBilinear; }

// ---------------------------------------------------------------------------
// Worker pool
// ---------------------------------------------------------------------------

class Pool {
 public:
  explicit Pool(int n) : stop_(false) {
    if (n < 1) n = 1;
    for (int i = 0; i < n; ++i)
      threads_.emplace_back([this] { worker(); });
  }
  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }
  // Run fn(i) for i in [0, n) across the pool; blocks until all done.
  void parallel_for(int n, const std::function<void(int)>& fn) {
    if (n <= 0) return;
    std::atomic<int> next(0), done(0);
    std::mutex done_mu;
    std::condition_variable done_cv;
    auto task = [&] {
      int i;
      while ((i = next.fetch_add(1)) < n) fn(i);
      {
        // notify while holding the lock: the waiting caller cannot pass the
        // predicate and destroy done_cv/done_mu between our unlock and notify
        std::lock_guard<std::mutex> lk(done_mu);
        ++done;
        done_cv.notify_one();
      }
    };
    int workers = static_cast<int>(threads_.size());
    int launched = workers < n ? workers : n;
    {
      std::unique_lock<std::mutex> lk(mu_);
      for (int i = 0; i < launched - 1; ++i) queue_.push(task);
    }
    cv_.notify_all();
    task();  // caller participates
    std::unique_lock<std::mutex> lk(done_mu);
    done_cv.wait(lk, [&] { return done.load() >= launched; });
  }

 private:
  void worker() {
    for (;;) {
      std::function<void()> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        job = std::move(queue_.front());
        queue_.pop();
      }
      job();
    }
  }
  std::vector<std::thread> threads_;
  std::queue<std::function<void()>> queue_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

void normalize_into(const uint8_t* src, int64_t n_px, int c, const float* mean,
                    const float* std_, float* out) {
  // exact op order of transforms.to_tensor + transforms.normalize:
  // f32(x) / 255.0f, - mean, / std  (single memory pass)
  for (int64_t i = 0; i < n_px; ++i) {
    const uint8_t* p = src + i * c;
    float* o = out + i * c;
    for (int ch = 0; ch < c; ++ch) {
      float t = static_cast<float>(p[ch]) / 255.0f;
      o[ch] = (t - mean[ch]) / std_[ch];
    }
  }
}

int prep_one(const uint8_t* src, int h, int w, int c, int y0, int x0, int ch_,
             int cw_, int oh, int ow, int filter_id, const float* mean,
             const float* std_, float* out, uint8_t* scratch) {
  // scratch must hold oh*ow*c bytes (resized u8 before normalize)
  int rc = resample(src, h, w, c, y0, x0, ch_, cw_, scratch, oh, ow,
                    filter_by_id(filter_id));
  if (rc != 0) return rc;
  normalize_into(scratch, static_cast<int64_t>(oh) * ow, c, mean, std_, out);
  return 0;
}

}  // namespace

extern "C" {

// u8 HWC crop+resize: dst [oh, ow, c]. filter: 0 = bilinear, 1 = bicubic.
int vt_resize_u8(const uint8_t* src, int h, int w, int c, int y0, int x0,
                 int ch_, int cw_, uint8_t* dst, int oh, int ow, int filter) {
  return resample(src, h, w, c, y0, x0, ch_, cw_, dst, oh, ow,
                  filter_by_id(filter));
}

// Fused (x/255 - mean)/std, u8 HWC -> f32 HWC.
void vt_normalize_u8(const uint8_t* src, int64_t n_px, int c, const float* mean,
                     const float* std_, float* out) {
  normalize_into(src, n_px, c, mean, std_, out);
}

// PIL "L" conversion: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16.
// stride = channel count of the source (>= 3; extra channels ignored,
// matching PIL convert("L") on RGBA).
void vt_rgb_to_gray(const uint8_t* src, int64_t n_px, int stride,
                    uint8_t* out) {
  for (int64_t i = 0; i < n_px; ++i) {
    const uint8_t* p = src + i * stride;
    out[i] = static_cast<uint8_t>(
        (p[0] * 19595 + p[1] * 38470 + p[2] * 7471 + 0x8000) >> 16);
  }
}

// compute_white_percentage (data/transforms.py): gray-convert, resize to
// (ref, ref) with BICUBIC when width > ref, fraction of pixels > 250.
float vt_white_percentage(const uint8_t* src, int h, int w, int c,
                          int ref_size) {
  std::vector<uint8_t> gray(static_cast<size_t>(h) * w);
  if (c >= 3) {
    vt_rgb_to_gray(src, static_cast<int64_t>(h) * w, c, gray.data());
  } else {
    for (int64_t i = 0; i < static_cast<int64_t>(h) * w; ++i)
      gray[i] = src[i * c];
  }
  const uint8_t* g = gray.data();
  int gh = h, gw = w;
  std::vector<uint8_t> small;
  if (w > ref_size) {
    small.resize(static_cast<size_t>(ref_size) * ref_size);
    resample(gray.data(), h, w, 1, 0, 0, h, w, small.data(), ref_size,
             ref_size, kBicubic);
    g = small.data();
    gh = gw = ref_size;
  }
  int64_t count = 0;
  for (int64_t i = 0; i < static_cast<int64_t>(gh) * gw; ++i)
    if (g[i] > 250) ++count;
  return static_cast<float>(count) / (static_cast<float>(gh) * gw);
}

// Crop -> resize -> normalize for one image, u8 HWC in, f32 HWC out.
int vt_prep_one(const uint8_t* src, int h, int w, int c, int y0, int x0,
                int ch_, int cw_, int oh, int ow, int filter, const float* mean,
                const float* std_, float* out) {
  std::vector<uint8_t> scratch(static_cast<size_t>(oh) * ow * c);
  return prep_one(src, h, w, c, y0, x0, ch_, cw_, oh, ow, filter, mean, std_,
                  out, scratch.data());
}

// ---------------------------------------------------------------------------
// Color jitter (data/transforms.py::color_jitter): PIL ImageEnhance
// brightness/contrast/saturation semantics (float32 blend with the
// degenerate image, truncating cast — verified bit-exact vs PIL over
// random factors in tests/test_torch_native_pipeline.py) plus the integer-HSV
// hue shift (h = floor(255*num/(6*cr)) exactly; PIL's float convert("HSV")
// differs by +-1/255 hue on ~0.3% of pixels — the numpy reference path in
// transforms.py uses the SAME integer formula, so native and Python are
// bit-identical).
// ---------------------------------------------------------------------------

inline uint8_t clip255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : static_cast<uint8_t>(v));
}

void jitter_brightness(uint8_t* p, int64_t n, float f) {
  // blend(black, img, f): (int)(f * x)
  for (int64_t i = 0; i < n; ++i)
    p[i] = clip255(static_cast<int>(f * static_cast<float>(p[i])));
}

void jitter_contrast(uint8_t* p, int64_t n_px, float f) {
  // degenerate = solid gray at int(mean(L) + 0.5)
  uint64_t sum = 0;
  for (int64_t i = 0; i < n_px; ++i) {
    const uint8_t* q = p + i * 3;
    sum += (q[0] * 19595u + q[1] * 38470u + q[2] * 7471u + 0x8000u) >> 16;
  }
  float mean = static_cast<float>(
      static_cast<int>(static_cast<double>(sum) / n_px + 0.5));
  for (int64_t i = 0; i < n_px * 3; ++i)
    p[i] = clip255(static_cast<int>(mean + f * (static_cast<float>(p[i]) - mean)));
}

void jitter_saturation(uint8_t* p, int64_t n_px, float f) {
  // degenerate = per-pixel gray (PIL "L")
  for (int64_t i = 0; i < n_px; ++i) {
    uint8_t* q = p + i * 3;
    float l = static_cast<float>(
        (q[0] * 19595u + q[1] * 38470u + q[2] * 7471u + 0x8000u) >> 16);
    for (int ch = 0; ch < 3; ++ch)
      q[ch] = clip255(static_cast<int>(l + f * (static_cast<float>(q[ch]) - l)));
  }
}

void jitter_hue(uint8_t* p, int64_t n_px, int shift) {
  for (int64_t i = 0; i < n_px; ++i) {
    uint8_t* q = p + i * 3;
    int r = q[0], g = q[1], b = q[2];
    int maxc = r > g ? (r > b ? r : b) : (g > b ? g : b);
    int minc = r < g ? (r < b ? r : b) : (g < b ? g : b);
    int cr = maxc - minc;
    int h, s;
    if (cr == 0) {
      h = 0;
      s = 0;
    } else {
      // exact integer hue: num in [0, 6*cr)
      int num = (r == maxc) ? (g - b)
                            : ((g == maxc) ? 2 * cr + (b - r) : 4 * cr + (r - g));
      num %= 6 * cr;
      if (num < 0) num += 6 * cr;
      h = (255 * num) / (6 * cr);
      s = (255 * cr) / maxc;
    }
    int v = maxc;
    h = (h + shift) % 256;
    if (h < 0) h += 256;
    // HSV -> RGB, PIL convert semantics (float32; verified bit-exact)
    float hf = static_cast<float>(h) / 255.0f;
    float sf = static_cast<float>(s) / 255.0f;
    float vf = static_cast<float>(v);
    int i6 = static_cast<int>(hf * 6.0f);
    float fr = hf * 6.0f - static_cast<float>(i6);
    int pp = static_cast<int>(vf * (1.0f - sf) + 0.5f);
    int qq = static_cast<int>(vf * (1.0f - sf * fr) + 0.5f);
    int tt = static_cast<int>(vf * (1.0f - sf * (1.0f - fr)) + 0.5f);
    int vi = v;
    switch (i6 % 6) {
      case 0: q[0] = clip255(vi); q[1] = clip255(tt); q[2] = clip255(pp); break;
      case 1: q[0] = clip255(qq); q[1] = clip255(vi); q[2] = clip255(pp); break;
      case 2: q[0] = clip255(pp); q[1] = clip255(vi); q[2] = clip255(tt); break;
      case 3: q[0] = clip255(pp); q[1] = clip255(qq); q[2] = clip255(vi); break;
      case 4: q[0] = clip255(tt); q[1] = clip255(pp); q[2] = clip255(vi); break;
      default: q[0] = clip255(vi); q[1] = clip255(pp); q[2] = clip255(qq); break;
    }
  }
}

// In-place jitter on an RGB u8 buffer. ops[i] in {0: brightness,
// 1: contrast, 2: saturation, 3: hue}; factors[i] is the enhance factor
// (ops 0-2) or the hue shift in [-255, 255] (op 3, pre-rounded to int).
void vt_color_jitter(uint8_t* img, int64_t n_px, const int32_t* ops,
                     const float* factors, int n_ops) {
  for (int i = 0; i < n_ops; ++i) {
    switch (ops[i]) {
      case 0: jitter_brightness(img, n_px * 3, factors[i]); break;
      case 1: jitter_contrast(img, n_px, factors[i]); break;
      case 2: jitter_saturation(img, n_px, factors[i]); break;
      case 3: jitter_hue(img, n_px, static_cast<int>(factors[i])); break;
      default: break;
    }
  }
}

// ---------------------------------------------------------------------------
// Affine warp (data/transforms.py::shift_scale_rotate / random_affine):
// cv2.warpAffine INTER_LINEAR semantics with a DETERMINISTIC float spec
// that this function canonically defines (the numpy mirror in
// data/transforms.py::warp_affine_plain implements the identical op order
// and is bit-exact against it — tests/test_torch_native_pipeline.py):
// - the FORWARD 2x3 matrix is inverted in double precision exactly like
//   cv2.invertAffineTransform,
// - source coords: row constant rc = f32(f32(iM1*y) + iM2) [two f32
//   roundings], then sx = f32(double(iM0)*x + double(rc)) [one rounding
//   of the product+add, matching numpy's float64 emulation of an fma],
// - bilinear blend in f32, strict left-to-right product form
//   p00*(1-fx)*(1-fy) + p01*fx*(1-fy) + p10*(1-fx)*fy + p11*fx*fy
//   (compiled with -ffp-contract=off so no implicit fma sneaks in),
// - rounding: nearest-even (rintf), clip to u8,
// - borders: 0 = BORDER_REFLECT_101, 1 = BORDER_CONSTANT(value).
// vs OpenCV 5.0's AVX2 kernel this measured ≥ 99.98% bit-identical pixels
// with max |diff| = 1 at exact rounding boundaries (the SIMD kernel's
// private fma/op order is not part of cv2's contract); the framework's
// canonical semantics are THIS spec on both the C++ and Python paths.
// ---------------------------------------------------------------------------

inline int64_t reflect101(int64_t p, int64_t len) {
  if (len == 1) return 0;
  int64_t per = 2 * (len - 1);
  int64_t out = (p < 0 ? -p : p) % per;
  return out >= len ? per - out : out;
}

void warp_affine_u8(const uint8_t* src, int h, int w, int c, const double* m,
                    uint8_t* dst, int border_mode, const uint8_t* border) {
  // invertAffineTransform (double, cv2 op order)
  double d = m[0] * m[4] - m[1] * m[3];
  d = d != 0.0 ? 1.0 / d : 0.0;
  double a11 = m[4] * d, a22 = m[0] * d, a12 = -m[1] * d, a21 = -m[3] * d;
  double im[6] = {a11, a12, -a11 * m[2] - a12 * m[5],
                  a21, a22, -a21 * m[2] - a22 * m[5]};

  const float ia0 = static_cast<float>(im[0]), ia1 = static_cast<float>(im[1]),
              ia2 = static_cast<float>(im[2]);
  const float ib0 = static_cast<float>(im[3]), ib1 = static_cast<float>(im[4]),
              ib2 = static_cast<float>(im[5]);
  const int64_t rs = static_cast<int64_t>(w) * c;

  // Row-sliced two-pass layout (~3x the naive per-pixel loop): pass 1 is
  // the pure-FP coordinate/weight math over the whole row in flat arrays,
  // pass 2 is the tap gather + blend with no per-pixel transcendentals;
  // the numerics are IDENTICAL ops per pixel. Pass 1 splits into (a) the
  // double mul-add coordinate loop (gcc auto-vectorizes it over double
  // lanes) and (b) an AVX2 floor/clamp/weight loop — the monolithic
  // scalar version measured 4.9 ms of the 7.6 ms 1000x800 warp; the
  // split runs it in 0.7 ms. The AVX path uses ordered-compare blends
  // (not min/max) so NaN coordinates take the same select arms as the
  // scalar ternaries, and cvttps matches the scalar int cast bit for bit.
  std::vector<float> w00v(w), w01v(w), w10v(w), w11v(w);
  std::vector<float> sxv(w + 8), syv(w + 8);
  std::vector<int32_t> x0v(w + 8), y0v(w + 8);
  for (int y = 0; y < h; ++y) {
    const float rcx = ia1 * static_cast<float>(y) + ia2;
    const float rcy = ib1 * static_cast<float>(y) + ib2;
    const double ia0d = ia0, ib0d = ib0, rcxd = rcx, rcyd = rcy;
    float* __restrict sxp = sxv.data();
    float* __restrict syp = syv.data();
    for (int x = 0; x < w; ++x) {
      sxp[x] = static_cast<float>(ia0d * x + rcxd);
      syp[x] = static_cast<float>(ib0d * x + rcyd);
    }
    int x1 = 0;
#if defined(__AVX2__)
    {
      // keep the TRUE integer coords (reflect101 is periodic, so far-out
      // values matter); clamp only at +-1e9 so the int cast of a huge /
      // non-finite float coordinate stays defined
      const __m256 lo = _mm256_set1_ps(-1e9f), hi = _mm256_set1_ps(1e9f);
      const __m256 one = _mm256_set1_ps(1.0f);
      for (; x1 + 8 <= w; x1 += 8) {
        __m256 vx = _mm256_loadu_ps(sxp + x1);
        __m256 vy = _mm256_loadu_ps(syp + x1);
        __m256 fxf = _mm256_floor_ps(vx), fyf = _mm256_floor_ps(vy);
        // ordered compares: NaN falls through to the untouched lane,
        // exactly like the scalar `a < lo ? lo : (a > hi ? hi : a)`
        __m256 xc = _mm256_blendv_ps(fxf, hi,
                                     _mm256_cmp_ps(fxf, hi, _CMP_GT_OQ));
        xc = _mm256_blendv_ps(xc, lo, _mm256_cmp_ps(fxf, lo, _CMP_LT_OQ));
        __m256 yc = _mm256_blendv_ps(fyf, hi,
                                     _mm256_cmp_ps(fyf, hi, _CMP_GT_OQ));
        yc = _mm256_blendv_ps(yc, lo, _mm256_cmp_ps(fyf, lo, _CMP_LT_OQ));
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(x0v.data() + x1),
                            _mm256_cvttps_epi32(xc));
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(y0v.data() + x1),
                            _mm256_cvttps_epi32(yc));
        __m256 fx = _mm256_sub_ps(vx, fxf), fy = _mm256_sub_ps(vy, fyf);
        __m256 gx = _mm256_sub_ps(one, fx), gy = _mm256_sub_ps(one, fy);
        _mm256_storeu_ps(w00v.data() + x1, _mm256_mul_ps(gx, gy));
        _mm256_storeu_ps(w01v.data() + x1, _mm256_mul_ps(fx, gy));
        _mm256_storeu_ps(w10v.data() + x1, _mm256_mul_ps(gx, fy));
        _mm256_storeu_ps(w11v.data() + x1, _mm256_mul_ps(fx, fy));
      }
    }
#endif
    for (; x1 < w; ++x1) {
      const float sx = sxp[x1], sy = syp[x1];
      const float fxf = std::floor(sx), fyf = std::floor(sy);
      float xc = fxf < -1e9f ? -1e9f : (fxf > 1e9f ? 1e9f : fxf);
      float yc = fyf < -1e9f ? -1e9f : (fyf > 1e9f ? 1e9f : fyf);
      x0v[x1] = static_cast<int32_t>(xc);
      y0v[x1] = static_cast<int32_t>(yc);
      const float fx = sx - fxf, fy = sy - fyf;
      w00v[x1] = (1.0f - fx) * (1.0f - fy);
      w01v[x1] = fx * (1.0f - fy);
      w10v[x1] = (1.0f - fx) * fy;
      w11v[x1] = fx * fy;
    }
    uint8_t* orow = dst + static_cast<int64_t>(y) * rs;
    int x = 0;
    while (x < w) {
      // extend the run of in-range pixels (coords move monotonically in
      // x, so runs are long: typically the whole interior of the row)
      int run = x;
      while (run < w && static_cast<uint32_t>(x0v[run]) <
                            static_cast<uint32_t>(w - 1) &&
             static_cast<uint32_t>(y0v[run]) < static_cast<uint32_t>(h - 1))
        ++run;
#if defined(__SSE4_1__)
      if (c == 3 && run - x > 1) {
        // SSE blend for RGB interior pixels: channels ride lanes 0-2,
        // taps loaded as adjacent 6-byte row pairs, nearest-even via
        // cvtps2dq — op-for-op the scalar expression below (mul+add,
        // no fma: -ffp-contract=off applies to intrinsics trivially).
        // The last pixel of the run is peeled: its 8-byte tap loads and
        // the 4-byte output store may touch the following pixel/byte.
        // Bottom-right corner taps (x0 == w-2 AND y0 == h-2, reachable
        // by non-last run pixels when the inverse x-step is < 1) drop to
        // the scalar tail: their 8-byte r1 load would read 2 bytes past
        // the end of the source buffer's last row.
        for (; x < run - 1; ++x) {
          if (__builtin_expect(x0v[x] == w - 2 && y0v[x] == h - 2, 0))
            break;
          const uint8_t* p = src + static_cast<int64_t>(y0v[x]) * rs +
                             static_cast<int64_t>(x0v[x]) * 3;
          __m128i r0 = _mm_loadl_epi64(
              reinterpret_cast<const __m128i*>(p));
          __m128i r1 = _mm_loadl_epi64(
              reinterpret_cast<const __m128i*>(p + rs));
          __m128 p00 = _mm_cvtepi32_ps(_mm_cvtepu8_epi32(r0));
          __m128 p01 = _mm_cvtepi32_ps(
              _mm_cvtepu8_epi32(_mm_srli_si128(r0, 3)));
          __m128 p10 = _mm_cvtepi32_ps(_mm_cvtepu8_epi32(r1));
          __m128 p11 = _mm_cvtepi32_ps(
              _mm_cvtepu8_epi32(_mm_srli_si128(r1, 3)));
          __m128 v = _mm_add_ps(
              _mm_add_ps(
                  _mm_add_ps(_mm_mul_ps(p00, _mm_set1_ps(w00v[x])),
                             _mm_mul_ps(p01, _mm_set1_ps(w01v[x]))),
                  _mm_mul_ps(p10, _mm_set1_ps(w10v[x]))),
              _mm_mul_ps(p11, _mm_set1_ps(w11v[x])));
          __m128i ri = _mm_cvtps_epi32(v);            // nearest-even
          __m128i pk = _mm_packus_epi16(_mm_packus_epi32(ri, ri), ri);
          // 4-byte store: byte 3 belongs to the NEXT pixel, which this
          // left-to-right loop overwrites on the following iteration
          *reinterpret_cast<int32_t*>(orow + static_cast<int64_t>(x) * 3) =
              _mm_cvtsi128_si32(pk);
        }
      }
#endif
      for (; x < run; ++x) {  // interior: no bounds checks
        const uint8_t* p = src + static_cast<int64_t>(y0v[x]) * rs +
                           static_cast<int64_t>(x0v[x]) * c;
        const float w00 = w00v[x], w01 = w01v[x], w10 = w10v[x],
                    w11 = w11v[x];
        uint8_t* o = orow + static_cast<int64_t>(x) * c;
        for (int ch = 0; ch < c; ++ch) {
          float v = static_cast<float>(p[ch]) * w00 +
                    static_cast<float>(p[c + ch]) * w01 +
                    static_cast<float>(p[rs + ch]) * w10 +
                    static_cast<float>(p[rs + c + ch]) * w11;
          int r = static_cast<int>(std::rintf(v));
          o[ch] = static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
        }
      }
      if (x >= w) break;
      // border pixel
      const int64_t x0 = x0v[x], y0 = y0v[x];
      const float w00 = w00v[x], w01 = w01v[x], w10 = w10v[x], w11 = w11v[x];
      uint8_t* o = orow + static_cast<int64_t>(x) * c;
      if (border_mode == 1) {  // BORDER_CONSTANT (per-tap)
        for (int ch = 0; ch < c; ++ch) {
          auto tap = [&](int64_t ty, int64_t tx) -> float {
            if (tx < 0 || tx >= w || ty < 0 || ty >= h)
              return static_cast<float>(border[ch]);
            return static_cast<float>(src[ty * rs + tx * c + ch]);
          };
          float v = tap(y0, x0) * w00 + tap(y0, x0 + 1) * w01 +
                    tap(y0 + 1, x0) * w10 + tap(y0 + 1, x0 + 1) * w11;
          int r = static_cast<int>(std::rintf(v));
          o[ch] = static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
        }
      } else {  // BORDER_REFLECT_101
        const int64_t sx0 = reflect101(x0, w), sx1 = reflect101(x0 + 1, w);
        const int64_t sy0 = reflect101(y0, h), sy1 = reflect101(y0 + 1, h);
        const uint8_t* r0 = src + sy0 * rs;
        const uint8_t* r1 = src + sy1 * rs;
        for (int ch = 0; ch < c; ++ch) {
          float v = static_cast<float>(r0[sx0 * c + ch]) * w00 +
                    static_cast<float>(r0[sx1 * c + ch]) * w01 +
                    static_cast<float>(r1[sx0 * c + ch]) * w10 +
                    static_cast<float>(r1[sx1 * c + ch]) * w11;
          int r = static_cast<int>(std::rintf(v));
          o[ch] = static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
        }
      }
      ++x;
    }
  }
}

#if VT_HAVE_JPEG
struct VtJpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void vt_jpeg_error_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<VtJpegErr*>(cinfo->err)->jb, 1);
}
#endif

// Parse a JPEG's output dimensions: hw = {height, width, channels}.
// Returns 0 on success, nonzero on parse failure / no libjpeg.
int vt_jpeg_dims(const uint8_t* buf, int64_t len, int32_t* hw) {
#if VT_HAVE_JPEG
  jpeg_decompress_struct cinfo;
  VtJpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = vt_jpeg_error_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_calc_output_dimensions(&cinfo);
  hw[0] = static_cast<int32_t>(cinfo.output_height);
  hw[1] = static_cast<int32_t>(cinfo.output_width);
  hw[2] = 3;
  jpeg_destroy_decompress(&cinfo);
  return 0;
#else
  (void)buf; (void)len; (void)hw;
  return 1;
#endif
}

// Decode a JPEG into a preallocated RGB u8 buffer [h, w, 3] (dims from
// vt_jpeg_dims). Returns 0 on success.
int vt_jpeg_decode(const uint8_t* buf, int64_t len, uint8_t* out, int h,
                   int w) {
#if VT_HAVE_JPEG
  jpeg_decompress_struct cinfo;
  VtJpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = vt_jpeg_error_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;   // PIL convert("RGB") target
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<int64_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
#else
  (void)buf; (void)len; (void)out; (void)h; (void)w;
  return 1;
#endif
}

// Affine warp of a u8 HWC image with the FORWARD 2x3 matrix m (row-major
// [m00 m01 m02 m10 m11 m12]); dst is [h, w, c] like src. border_mode
// 0 = BORDER_REFLECT_101, 1 = BORDER_CONSTANT with border[c] values.
// Bit-exact vs cv2.warpAffine(..., INTER_LINEAR) — see warp_affine_u8.
void vt_warp_affine_u8(const uint8_t* src, int h, int w, int c,
                       const double* m, uint8_t* dst, int border_mode,
                       const uint8_t* border) {
  warp_affine_u8(src, h, w, c, m, dst, border_mode, border);
}

// ---------------------------------------------------------------------------
// Gaussian blur (data/transforms.py::GaussianBlur): BIT-EXACT vs
// PIL ImageFilter.GaussianBlur (Pillow BoxBlur.c): three box-blur passes
// per direction at the Gwosdek box radius, 24.8 fixed point, per-pass
// uint8 rounding. The radius arithmetic replicates the C float (not
// double) locals of Pillow's ImagingGaussianBlur — the box radius,
// ww and fw must round identically or outputs shift by one at specific
// radii (verified by a dense radius sweep in
// tests/test_torch_native_pipeline.py).
//
// Layout strategy: Pillow runs its scalar horizontal line blur 3x, then
// transposes, 3x, transposes back. Here BOTH directions run as an
// axis-0 (row-direction) pass whose inner loop is over the W*C
// contiguous lanes of each row — auto-vectorized u32 adds/multiplies
// over full AVX registers — with the same two pixel transposes Pillow
// already pays. Order (horizontal first) and per-pass rounding match,
// so results are bit-identical while each pass runs SIMD-wide.
// ---------------------------------------------------------------------------

static void blur_params(float radius, int passes, int* int_radius,
                        uint32_t* ww, uint32_t* fw) {
  // Pillow ImagingGaussianBlur: float locals, double only inside the
  // sqrt/floor expressions (C promotion), each assignment a float round
  float sigma2 = radius * radius / passes;
  float L = (float)std::sqrt(12.0 * (double)sigma2 + 1.0);
  float l = (float)std::floor(((double)L - 1.0) / 2.0);
  float a = (2.0f * l + 1.0f) * (l * (l + 1.0f) - 3.0f * sigma2);
  a /= 6.0f * (sigma2 - (l + 1.0f) * (l + 1.0f));
  float fr = l + a;
  int r = (int)fr;
  uint32_t w = (uint32_t)((float)(1 << 24) / (fr * 2.0f + 1.0f));
  *int_radius = r;
  *ww = w;
  *fw = ((uint32_t)(1 << 24) - (uint32_t)(r * 2 + 1) * w) / 2;
}

// One box-blur pass along axis 0 of an [n, lanes] u8 buffer (all lanes
// independent -> the j-loops vectorize across the full row width).
static void box_pass_axis0(const uint8_t* in, uint8_t* out, int n,
                           int64_t lanes, int radius, uint32_t ww,
                           uint32_t fw, uint32_t* acc) {
  int last = n - 1;
  int edge_a = radius + 1 < n ? radius + 1 : n;
  int edge_b = n - radius - 1 > 0 ? n - radius - 1 : 0;
  const uint8_t* rl = in + (int64_t)last * lanes;

  for (int64_t j = 0; j < lanes; ++j)
    acc[j] = (uint32_t)in[j] * (uint32_t)(radius + 1);
  for (int y = 0; y < edge_a - 1; ++y) {
    const uint8_t* r = in + (int64_t)y * lanes;
    for (int64_t j = 0; j < lanes; ++j) acc[j] += r[j];
  }
  for (int64_t j = 0; j < lanes; ++j)
    acc[j] += (uint32_t)rl[j] * (uint32_t)(radius - edge_a + 1);

  const uint32_t half = 1u << 23;
  auto emit = [&](int y, const uint8_t* sub, const uint8_t* add,
                  const uint8_t* farA, const uint8_t* farB) {
    uint8_t* o = out + (int64_t)y * lanes;
    for (int64_t j = 0; j < lanes; ++j) {
      acc[j] += (uint32_t)add[j] - (uint32_t)sub[j];
      uint32_t bulk = acc[j] * ww + ((uint32_t)farA[j] + farB[j]) * fw;
      o[j] = (uint8_t)((bulk + half) >> 24);
    }
  };

  auto row = [&](int y) { return in + (int64_t)y * lanes; };
  if (edge_a <= edge_b) {
    for (int y = 0; y < edge_a; ++y)
      emit(y, row(0), row(y + radius), row(0), row(y + radius + 1));
    for (int y = edge_a; y < edge_b; ++y)
      emit(y, row(y - radius - 1), row(y + radius), row(y - radius - 1),
           row(y + radius + 1));
    for (int y = edge_b; y <= last; ++y)
      emit(y, row(y - radius - 1), row(last), row(y - radius - 1),
           row(last));
  } else {
    auto clamp = [&](int y) { return y < 0 ? 0 : (y > last ? last : y); };
    for (int y = 0; y <= last; ++y)
      emit(y, row(clamp(y - radius - 1)), row(clamp(y + radius)),
           row(clamp(y - radius - 1)), row(clamp(y + radius + 1)));
  }
}

static void transpose_px(const uint8_t* in, uint8_t* out, int h, int w,
                         int c) {
  // [h, w, c] -> [w, h, c], blocked for cache
  const int B = 32;
  for (int y0 = 0; y0 < h; y0 += B)
    for (int x0 = 0; x0 < w; x0 += B) {
      int y1 = y0 + B < h ? y0 + B : h, x1 = x0 + B < w ? x0 + B : w;
      for (int y = y0; y < y1; ++y)
        for (int x = x0; x < x1; ++x)
          for (int k = 0; k < c; ++k)
            out[((int64_t)x * h + y) * c + k] =
                in[((int64_t)y * w + x) * c + k];
    }
}

void vt_gaussian_blur_u8(const uint8_t* src, int h, int w, int c,
                         float radius, uint8_t* dst) {
  int r;
  uint32_t ww, fw;
  blur_params(radius, 3, &r, &ww, &fw);
  int64_t n = (int64_t)h * w * c;
  std::vector<uint8_t> a((size_t)n), b((size_t)n);
  int64_t lanes_t = (int64_t)h * c;  // transposed: [w, h, c]
  int64_t lanes = (int64_t)w * c;
  std::vector<uint32_t> acc((size_t)(lanes_t > lanes ? lanes_t : lanes));

  // horizontal direction first (Pillow order): transpose, 3 axis-0
  // passes along what was W, transpose back, 3 axis-0 passes along H
  transpose_px(src, a.data(), h, w, c);
  box_pass_axis0(a.data(), b.data(), w, lanes_t, r, ww, fw, acc.data());
  box_pass_axis0(b.data(), a.data(), w, lanes_t, r, ww, fw, acc.data());
  box_pass_axis0(a.data(), b.data(), w, lanes_t, r, ww, fw, acc.data());
  transpose_px(b.data(), a.data(), w, h, c);
  box_pass_axis0(a.data(), b.data(), h, lanes, r, ww, fw, acc.data());
  box_pass_axis0(b.data(), a.data(), h, lanes, r, ww, fw, acc.data());
  box_pass_axis0(a.data(), dst, h, lanes, r, ww, fw, acc.data());
}

void* vt_pool_create(int n_threads) { return new Pool(n_threads); }

void vt_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

// Prepare a batch: n images, each with its own dims [h, w] (shared channel
// count), crop rect [y0, x0, ch, cw], into out[n, oh, ow, c] f32.
// Returns 0 iff every image succeeded.
int vt_pool_prep_batch(void* pool, const uint8_t** srcs, const int32_t* dims,
                       const int32_t* crops, int n, int c, int oh, int ow,
                       int filter, const float* mean, const float* std_,
                       float* out) {
  std::atomic<int> rc(0);
  int64_t px = static_cast<int64_t>(oh) * ow;
  auto work = [&](int i) {
    std::vector<uint8_t> scratch(static_cast<size_t>(px) * c);
    int r = prep_one(srcs[i], dims[i * 2], dims[i * 2 + 1], c, crops[i * 4],
                     crops[i * 4 + 1], crops[i * 4 + 2], crops[i * 4 + 3], oh,
                     ow, filter, mean, std_, out + i * px * c, scratch.data());
    if (r != 0) rc.store(r);
  };
  if (pool != nullptr) {
    static_cast<Pool*>(pool)->parallel_for(n, work);
  } else {
    for (int i = 0; i < n; ++i) work(i);
  }
  return rc.load();
}

}  // extern "C"
