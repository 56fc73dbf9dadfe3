// Native host input pipeline: fused JPEG decode -> Gaussian blur -> affine
// crop/rotate -> pixel noise -> [0,1] -> mean/std normalize, one C call per
// sample.
//
// The port's copy of uvhand_tpu/native/pipeline.cpp, its arithmetic
// unchanged. It replaces the image half of ArcticDataset.__getitem__
// (uvhand_tpu_torch/data/arctic.py: cv2.imread + augment.rgb_processing +
// augment.normalize_image; the reference's rgb_processing in
// arctic_tools/common/data_utils.py and the imread/cvtColor of its
// arctic_dataset.py). Wins over the Python path:
//
//  1. ROI decode: the 224x224 warp samples only the (rotated) crop window,
//     so the decoder runs jpeg_crop_scanline + jpeg_skip_scanlines and
//     produces only those MCU rows/columns — bit-exact for baseline JPEGs
//     (MCUs are independent after the Huffman parse, which skipping still
//     performs).
//  2. ROI filtering: Gaussian blur, float conversion and the warp read only
//     the window + apron instead of the whole frame.
//  3. Fused epilogue: noise-gain, clip, /255 and mean/std in one pass,
//     writing the final normalized float32 — no intermediate numpy arrays.
//  4. `fast=1` additionally decodes at libjpeg scale_num/8, the smallest
//     scale that keeps the window >= img_res (geometry stays exact via the
//     rescaled affine; the fixed 5x5/sigma-8 pre-blur then acts on fewer
//     pixels, so pixels differ slightly — opt-in).
//
// Exactness (fast=0): identical OpenCV float32 ops on an identically
// decoded RGB window; the parity test bounds residual JPEG-decoder
// rounding between the cv2 wheel and the system libjpeg-turbo.
//
// Thread-safety: no globals; each call is independent. Python callers run
// it from DataLoader's worker threads — ctypes releases the GIL for the
// duration of the call, so N workers scale natively.

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// gen_trans_from_patch_cv (uvhand_tpu_torch/data/augment.py, itself the
// reference's data_utils patch transform): three correspondence points
// through cv::getAffineTransform, rotation about the bbox center.
cv::Mat patch_affine(float cx, float cy, float src_w, float src_h,
                     float dst_w, float dst_h, float rot_deg) {
  const float rot_rad = static_cast<float>(CV_PI) * rot_deg / 180.f;
  const float cs = std::cos(rot_rad), sn = std::sin(rot_rad);
  auto rot2d = [&](float x, float y) {
    return cv::Point2f(x * cs - y * sn, x * sn + y * cs);
  };
  cv::Point2f src[3], dst[3];
  src[0] = cv::Point2f(cx, cy);
  src[1] = src[0] + rot2d(0.f, src_h * 0.5f);
  src[2] = src[0] + rot2d(src_w * 0.5f, 0.f);
  dst[0] = cv::Point2f(dst_w * 0.5f, dst_h * 0.5f);
  dst[1] = dst[0] + cv::Point2f(0.f, dst_h * 0.5f);
  dst[2] = dst[0] + cv::Point2f(dst_w * 0.5f, 0.f);
  cv::Mat m = cv::getAffineTransform(src, dst);  // CV_64F
  cv::Mat m32;
  m.convertTo(m32, CV_32F);  // python casts to float32 before warpAffine
  return m32;
}

// Source-space bounding box of everything the warp + blur will read:
// inverse-map the dst corners, expand by the blur apron (2) + cubic taps
// (2) + float slack.
cv::Rect src_roi(const cv::Mat& trans32, int img_res, int W, int H) {
  cv::Mat inv;
  cv::invertAffineTransform(trans32, inv);
  const float* m = inv.ptr<float>(0);
  float x0 = 1e30f, y0 = 1e30f, x1 = -1e30f, y1 = -1e30f;
  const float cs[4][2] = {{0.f, 0.f},
                          {static_cast<float>(img_res), 0.f},
                          {0.f, static_cast<float>(img_res)},
                          {static_cast<float>(img_res),
                           static_cast<float>(img_res)}};
  for (auto& c : cs) {
    float sx = m[0] * c[0] + m[1] * c[1] + m[2];
    float sy = m[3] * c[0] + m[4] * c[1] + m[5];
    x0 = std::min(x0, sx), x1 = std::max(x1, sx);
    y0 = std::min(y0, sy), y1 = std::max(y1, sy);
  }
  const int margin = 8;
  int ix0 = std::max(0, static_cast<int>(std::floor(x0)) - margin);
  int iy0 = std::max(0, static_cast<int>(std::floor(y0)) - margin);
  int ix1 = std::min(W, static_cast<int>(std::ceil(x1)) + margin);
  int iy1 = std::min(H, static_cast<int>(std::ceil(y1)) + margin);
  if (ix1 <= ix0 || iy1 <= iy0) return cv::Rect(0, 0, 0, 0);
  return cv::Rect(ix0, iy0, ix1 - ix0, iy1 - iy0);
}

// ROI-cropped (optionally scaled) libjpeg decode straight to RGB.
// On success fills `out` (CV_8UC3), the actual ROI offset (MCU-aligned by
// jpeg_crop_scanline) and the scale factors; returns true.
bool decode_jpeg_roi(const char* path, float min_src_extent, int img_res,
                     float cx, float cy, float crop_dim, float rot_deg,
                     cv::Mat* out, int* roi_x, int* roi_y, float* sx,
                     float* sy) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  // sniff JPEG magic; PNG etc. fall back to cv::imread in the caller
  unsigned char magic[2];
  if (fread(magic, 1, 2, f) != 2 || magic[0] != 0xFF || magic[1] != 0xD8) {
    fclose(f);
    return false;
  }
  rewind(f);

  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);

  int num = 8;
  if (min_src_extent > 0.f) {  // fast mode: smallest num/8 with window>=res
    num = static_cast<int>(8.f * img_res / min_src_extent) + 1;
    num = std::min(8, std::max(1, num));
  }
  cinfo.scale_num = num;
  cinfo.scale_denom = 8;
  cinfo.out_color_space = JCS_RGB;  // libjpeg converts YCbCr natively
  cinfo.dct_method = JDCT_ISLOW;    // match the default decoder quality
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_components != 3) longjmp(jerr.jb, 1);

  const int W = cinfo.output_width, H = cinfo.output_height;
  *sx = static_cast<float>(W) / static_cast<float>(cinfo.image_width);
  *sy = static_cast<float>(H) / static_cast<float>(cinfo.image_height);

  cv::Mat trans = patch_affine(cx * *sx, cy * *sy, crop_dim * *sx,
                               crop_dim * *sy, static_cast<float>(img_res),
                               static_cast<float>(img_res), rot_deg);
  cv::Rect roi = src_roi(trans, img_res, W, H);
  if (roi.width <= 0) longjmp(jerr.jb, 1);

  // column crop: libjpeg aligns xoffset down to the iMCU boundary and
  // widens the region accordingly — take what it gives us
  JDIMENSION xoff = roi.x, xw = roi.width;
  jpeg_crop_scanline(&cinfo, &xoff, &xw);
  out->create(roi.height, static_cast<int>(xw), CV_8UC3);
  if (roi.y > 0) jpeg_skip_scanlines(&cinfo, roi.y);
  for (int r = 0; r < roi.height; ++r) {
    JSAMPROW row = out->ptr<uint8_t>(r);
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  const JDIMENSION rest = cinfo.output_height - cinfo.output_scanline;
  if (rest > 0) jpeg_skip_scanlines(&cinfo, rest);
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  *roi_x = static_cast<int>(xoff);
  *roi_y = roi.y;
  return true;
}

}  // namespace

extern "C" {

int uv_pipeline_version() { return 2; }

// One sample: path -> normalized (img_res, img_res, 3) float32 RGB (HWC).
//   cx, cy         bbox center, full-image pixels
//   crop_dim       crop window extent in pixels (already int()-truncated and
//                  scale-augmented by the caller, matching rgb_processing)
//   rot_deg        in-plane rotation augmentation
//   pn             3 per-channel RGB noise gains
//   mean, std      normalization constants (RGB)
//   fast           1 = scaled libjpeg decode (geometry-exact, decode-res
//                  approximate); 0 = full-res decode, OpenCV-identical path
// Returns 0 on success, 1 when the image cannot be read/decoded (caller
// falls back to the Python zero-image/is_valid=0 path).
int uv_process_image(const char* path, float cx, float cy, float crop_dim,
                     float rot_deg, const float* pn, const float* mean,
                     const float* stdv, int img_res, int fast, float* out) {
  if (!path || !pn || !mean || !stdv || !out || img_res <= 0 ||
      crop_dim <= 0.f)
    return 2;

  cv::Mat rgb_u8;
  int rx = 0, ry = 0;
  float sx = 1.f, sy = 1.f;
  if (!decode_jpeg_roi(path, fast ? crop_dim : 0.f, img_res, cx, cy,
                       crop_dim, rot_deg, &rgb_u8, &rx, &ry, &sx, &sy)) {
    // non-JPEG or decoder failure: whole-image OpenCV fallback
    cv::Mat bgr = cv::imread(path, cv::IMREAD_COLOR);
    if (bgr.empty()) return 1;
    cv::cvtColor(bgr, rgb_u8, cv::COLOR_BGR2RGB);
    sx = sy = 1.f;
    rx = ry = 0;
  }

  // affine into the decoded window: same transform, source shifted by the
  // window origin
  cv::Mat trans = patch_affine(cx * sx - rx, cy * sy - ry, crop_dim * sx,
                               crop_dim * sy, static_cast<float>(img_res),
                               static_cast<float>(img_res), rot_deg);

  cv::Mat rgb;
  rgb_u8.convertTo(rgb, CV_32FC3);  // blur/warp on float RGB, like the
                                    // python path (arctic.py:221)
  cv::Mat blur;
  cv::GaussianBlur(rgb, blur, cv::Size(5, 5), 8.0);
  cv::Mat patch;
  cv::warpAffine(blur, patch, trans, cv::Size(img_res, img_res),
                 cv::INTER_CUBIC);

  // fused epilogue: noise * clip -> [0,1] -> (x - mean)/std, one pass
  const float inv255 = 1.f / 255.f;
  float inv_std[3], m3[3], g3[3];
  for (int c = 0; c < 3; ++c) {
    inv_std[c] = 1.f / stdv[c];
    m3[c] = mean[c];
    g3[c] = pn[c];
  }
  const int n = img_res * img_res;
  const float* p = patch.ptr<float>(0);
  for (int i = 0; i < n; ++i) {
    float* o = out + 3 * i;
    for (int c = 0; c < 3; ++c) {
      float v = p[3 * i + c] * g3[c];
      v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
      o[c] = (v * inv255 - m3[c]) * inv_std[c];
    }
  }
  return 0;
}

}  // extern "C"
