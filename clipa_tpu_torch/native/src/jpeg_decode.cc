// JPEG decode + crop + resize — the host hot path for CLIPA pretraining.
//
// Fuses what the reference delegated to TF's C++ decode_and_crop_jpeg
// (clipa_jax/transforms/ops_image.py:167-219): libjpeg DCT-domain scaling
// picks the cheapest decode resolution that still oversamples the target
// crop, then a bilinear resize produces the final (size x size x 3) uint8
// patch. For 84px targets from ~500px LAION JPEGs this skips ~98% of the
// inverse-DCT and color-conversion work.
//
// Exported C API (ctypes):
//   jpeg_info(buf, len, &w, &h)                              -> 0 / -1
//   jpeg_decode_crop_resize(buf, len, top, left, ch, cw,     -> 0 / -errno
//                           out_h, out_w, out_buf)
//      crop box in ORIGINAL image coordinates; pass ch==cw==0 for full
//      image. out_buf must hold out_h*out_w*3 bytes.

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Bilinear resize uint8 HWC -> uint8 HWC.
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int dh, int dw) {
  const float ys = (float)sh / dh;
  const float xs = (float)sw / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * ys - 0.5f;
    int y0 = fy < 0 ? 0 : (int)fy;
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * xs - 0.5f;
      int x0 = fx < 0 ? 0 : (int)fx;
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int c = 0; c < 3; ++c) {
        float a = src[(y0 * sw + x0) * 3 + c] * (1 - wx) +
                  src[(y0 * sw + x1) * 3 + c] * wx;
        float b = src[(y1 * sw + x0) * 3 + c] * (1 - wx) +
                  src[(y1 * sw + x1) * 3 + c] * wx;
        float val = a * (1 - wy) + b * wy;
        dst[(y * dw + x) * 3 + c] = (uint8_t)(val + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

int jpeg_info(const uint8_t* buf, int64_t len, int* width, int* height) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  *width = (int)cinfo.image_width;
  *height = (int)cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int jpeg_decode_crop_resize(const uint8_t* buf, int64_t len, int top,
                            int left, int crop_h, int crop_w, int out_h,
                            int out_w, uint8_t* out_buf) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);

  const int iw = (int)cinfo.image_width;
  const int ih = (int)cinfo.image_height;
  if (crop_w <= 0 || crop_h <= 0) {
    top = left = 0;
    crop_h = ih;
    crop_w = iw;
  }
  if (top < 0 || left < 0 || top + crop_h > ih || left + crop_w > iw) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }

  // DCT scaling: smallest s/8 with crop*s/8 >= out for both dims.
  int denom;
  for (denom = 1; denom < 8; ++denom) {
    if ((int64_t)crop_w * denom / 8 >= out_w &&
        (int64_t)crop_h * denom / 8 >= out_h)
      break;
  }
  cinfo.scale_num = (unsigned)denom;
  cinfo.scale_denom = 8;
  cinfo.out_color_space = JCS_RGB;
  cinfo.dct_method = JDCT_IFAST;
  cinfo.do_fancy_upsampling = FALSE;
  jpeg_calc_output_dimensions(&cinfo);

  const int ow = (int)cinfo.output_width;
  const int oh = (int)cinfo.output_height;
  // crop box in scaled coordinates
  int s_top = (int)((int64_t)top * oh / ih);
  int s_left = (int)((int64_t)left * ow / iw);
  int s_ch = (int)((int64_t)crop_h * oh / ih);
  int s_cw = (int)((int64_t)crop_w * ow / iw);
  if (s_ch < 1) s_ch = 1;
  if (s_cw < 1) s_cw = 1;
  if (s_top + s_ch > oh) s_top = oh - s_ch;
  if (s_left + s_cw > ow) s_left = ow - s_cw;
  if (s_top < 0) s_top = 0;
  if (s_left < 0) s_left = 0;

  jpeg_start_decompress(&cinfo);

  // libjpeg horizontal crop-on-decode (must be aligned to iMCU); we ask for
  // a slightly wider region then slice exactly.
  JDIMENSION cx = (JDIMENSION)s_left;
  JDIMENSION cw2 = (JDIMENSION)s_cw;
  jpeg_crop_scanline(&cinfo, &cx, &cw2);
  const int stride = (int)cw2 * 3;
  std::vector<uint8_t> cropped((size_t)s_ch * s_cw * 3);
  std::vector<uint8_t> row((size_t)stride);

  jpeg_skip_scanlines(&cinfo, (JDIMENSION)s_top);
  const int x_off = s_left - (int)cx;
  for (int y = 0; y < s_ch; ++y) {
    uint8_t* rowptr = row.data();
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
    std::memcpy(&cropped[(size_t)y * s_cw * 3], row.data() + x_off * 3,
                (size_t)s_cw * 3);
  }
  jpeg_skip_scanlines(&cinfo, cinfo.output_height - s_top - s_ch);
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  resize_bilinear(cropped.data(), s_ch, s_cw, out_buf, out_h, out_w);
  return 0;
}

}  // extern "C"
