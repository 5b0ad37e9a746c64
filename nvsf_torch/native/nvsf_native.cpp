// Native host-side data pipeline of nvsf_torch (the port's copy of
// nvsf_tpu/native/nvsf_native.cpp).
//
// Replaces the reference's per-point Python loops (nvsf/lib/convert.py:105-181)
// and complements the vectorized numpy paths for throughput-critical
// preprocessing: LiDAR -> pano scatter-min projection, pano -> point cloud
// expansion, and raw velodyne .bin batch conversion.
//
// Build: g++ -O3 -shared -fPIC, at first use, by nvsf_torch/native/binding.py.
// Binding: ctypes (nvsf_torch/native/binding.py).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// Project an (N, 4) [x, y, z, intensity] cloud into an (H, W) range image.
// Closest-return-wins conflict resolution, identical geometry to
// nvsf_torch/lib/convert.py::lidar_to_pano_with_intensities.
void lidar_to_pano_with_intensities(
    const double* pts, int64_t n,
    int64_t H, int64_t W,
    double fov_up, double fov,
    double fov_hoz_up, double fov_hoz,
    double max_depth,
    double* pano, double* inten) {
  const double deg2rad = M_PI / 180.0;
  const double fov_down = fov - fov_up;
  const double col_scale = (fov_hoz * deg2rad) / (double)W;
  const double row_scale = (fov * deg2rad) / (double)H;
  std::memset(pano, 0, sizeof(double) * H * W);
  std::memset(inten, 0, sizeof(double) * H * W);
  for (int64_t i = 0; i < n; ++i) {
    const double x = pts[i * 4 + 0];
    const double y = pts[i * 4 + 1];
    const double z = pts[i * 4 + 2];
    const double v = pts[i * 4 + 3];
    const double dist = std::sqrt(x * x + y * y + z * z);
    if (dist >= max_depth) continue;
    const double beta = fov_hoz_up * deg2rad - std::atan2(y, x);
    const double alpha =
        std::atan2(z, std::sqrt(x * x + y * y)) + fov_down * deg2rad;
    const int64_t c = (int64_t)std::llround(beta / col_scale);
    const int64_t r = (int64_t)std::llround((double)H - alpha / row_scale);
    if (r < 0 || r >= H || c < 0 || c >= W) continue;
    double* cell = pano + r * W + c;
    if (*cell == 0.0 || *cell > dist) {
      *cell = dist;
      inten[r * W + c] = v;
    }
  }
}

// Expand an (H, W) depth + intensity pano to an (M<=H*W, 4) point cloud.
// Returns the number of emitted points. out must hold H*W*4 doubles.
int64_t pano_to_lidar_with_intensities(
    const double* pano, const double* inten,
    int64_t H, int64_t W,
    double fov_up, double fov,
    double fov_hoz_up, double fov_hoz,
    double* out) {
  const double deg2rad = M_PI / 180.0;
  int64_t m = 0;
  for (int64_t j = 0; j < H; ++j) {
    const double alpha = (fov_up - (double)j / (double)H * fov) * deg2rad;
    const double ca = std::cos(alpha), sa = std::sin(alpha);
    for (int64_t i = 0; i < W; ++i) {
      const double d = pano[j * W + i];
      if (d == 0.0) continue;
      const double beta =
          -((double)i - (double)W / 2.0) / (double)W * fov_hoz * deg2rad;
      out[m * 4 + 0] = d * ca * std::cos(beta);
      out[m * 4 + 1] = d * ca * std::sin(beta);
      out[m * 4 + 2] = d * sa;
      out[m * 4 + 3] = inten[j * W + i];
      ++m;
    }
  }
  return m;
}

// Read a raw KITTI velodyne .bin ((N, 4) float32) and project it directly
// to a float32 (H, W, 3) [zeros, intensity, depth] range view in one pass —
// the whole preprocessing inner loop in native code without materializing
// the point cloud in Python. Returns 0 on success.
int32_t velodyne_bin_to_rangeview(
    const char* path,
    int64_t H, int64_t W,
    double fov_up, double fov,
    double fov_hoz_up, double fov_hoz,
    double max_depth,
    float* out_hw3) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  const long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  const int64_t n = bytes / (4 * sizeof(float));
  std::vector<float> buf(n * 4);
  if (std::fread(buf.data(), sizeof(float), n * 4, f) != (size_t)(n * 4)) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);

  std::vector<double> pts(n * 4);
  for (int64_t i = 0; i < n * 4; ++i) pts[i] = (double)buf[i];
  std::vector<double> pano(H * W), inten(H * W);
  lidar_to_pano_with_intensities(pts.data(), n, H, W, fov_up, fov,
                                 fov_hoz_up, fov_hoz, max_depth,
                                 pano.data(), inten.data());
  for (int64_t j = 0; j < H * W; ++j) {
    out_hw3[j * 3 + 0] = 0.0f;
    out_hw3[j * 3 + 1] = (float)inten[j];
    out_hw3[j * 3 + 2] = (float)pano[j];
  }
  return 0;
}

}  // extern "C"
