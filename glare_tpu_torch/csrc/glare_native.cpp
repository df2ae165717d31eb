// glare_native: the C++ host data-path core of glare_tpu_torch (the port's own
// copy of native/glare_native.cpp, with one change: the 256-entry value table of
// the uint8 -> float32 conversion is handed in by the caller).
//
// The table is what the plain numpy version (utils/imgproc.preprocess_padded)
// gives for the 256 byte values: x / 255, optionally log(clamp(x + eps, eps)).
// numpy's float32 log and the C library's logf differ in the last bit for some
// inputs, so computing the table here would break bit-equality with the plain
// version; taking it from the caller keeps every entry bit-equal to numpy.
// Fused loops: table lookup + reflect pad into a preallocated NHWC slot, and
// crop + flip / rot90. C ABI for ctypes; built with g++ -O3 -shared -fPIC by
// glare_tpu_torch/data/native.py.
//
// Protocol parity targets:
//   log transform      - reference code/data/LoL_dataset.py:493-494
//   reflect pad        - reference code/infer_dataset_lol.py:71-72
//   flip/rot augment   - reference code/data/LoL_dataset.py:183-216

#include <cstdint>
#include <cstring>

extern "C" {

// uint8 -> float32 through the caller's 256-entry table.
void u8_to_f32_lut(const uint8_t* src, float* dst, int64_t n, const float* lut) {
  for (int64_t i = 0; i < n; ++i) dst[i] = lut[src[i]];
}

// Fused: uint8 HWC image -> reflect-padded float32 through the caller's table,
// written into a preallocated NHWC batch slot. One pass over the output.
void preprocess_into_batch(const uint8_t* src, float* batch_slot, int h,
                           int w, int c, int top, int bottom, int left,
                           int right, const float* lut) {
  const int oh = h + top + bottom;
  const int ow = w + left + right;
  for (int oy = 0; oy < oh; ++oy) {
    int sy = oy - top;
    if (sy < 0) sy = -sy;
    if (sy >= h) sy = 2 * (h - 1) - sy;
    const uint8_t* srow = src + (int64_t)sy * w * c;
    float* drow = batch_slot + (int64_t)oy * ow * c;
    for (int ox = 0; ox < ow; ++ox) {
      int sx = ox - left;
      if (sx < 0) sx = -sx;
      if (sx >= w) sx = 2 * (w - 1) - sx;
      const uint8_t* sp = srow + (int64_t)sx * c;
      float* dp = drow + (int64_t)ox * c;
      for (int ch = 0; ch < c; ++ch) dp[ch] = lut[sp[ch]];
    }
  }
}

// Crop + flip/rot90 augment + convert, fused (train-path hot loop).
// rot90: 0/1/3 quarter turns (reference uses np.rot90 choices {0,1,3}).
// Output size: he x we (swapped when rot90 is odd).
void crop_augment_f32(const float* src, float* dst, int w_src, int c,
                      int top, int left, int hc, int wc, int hflip,
                      int vflip, int rot90) {
  // gather crop with flips into a temp orientation, then rotate
  // dst dims: rot90 odd -> (wc, hc), else (hc, wc)
  for (int y = 0; y < hc; ++y) {
    for (int x = 0; x < wc; ++x) {
      int sy = top + (vflip ? (hc - 1 - y) : y);
      int sx = left + (hflip ? (wc - 1 - x) : x);
      const float* sp = src + ((int64_t)sy * w_src + sx) * c;
      int dy, dx, dw;
      if (rot90 == 1) {        // (y, x) -> (wc-1-x, y)
        dy = wc - 1 - x; dx = y; dw = hc;
      } else if (rot90 == 3) { // (y, x) -> (x, hc-1-y)
        dy = x; dx = hc - 1 - y; dw = hc;
      } else {
        dy = y; dx = x; dw = wc;
      }
      std::memcpy(dst + ((int64_t)dy * dw + dx) * c, sp, sizeof(float) * c);
    }
  }
}

int glare_native_version() { return 2; }

}  // extern "C"
