// Baseline JPEG decoding with nvJPEG (CUDA toolkit), for the port's
// image_io.read_rgb where OpenCV is not installed. A plain C interface,
// bound with ctypes by mggan_tpu_torch/data/image_io.py, which builds this
// file with g++ at first use into mggan_tpu_torch/_build/ and links
// libnvjpeg.
//
// The output is interleaved RGB, uint8, written into a device buffer the
// caller allocated (pitch = 3 * width bytes), on the caller's stream. The
// caller synchronizes the stream before reading it. One nvJPEG handle and
// decode state serve every call of the process.

#include <cstddef>
#include <mutex>

#include <nvjpeg.h>

namespace {

nvjpegHandle_t g_handle = nullptr;
nvjpegJpegState_t g_state = nullptr;
std::mutex g_mutex;

int ensure_handle() {
    if (g_handle != nullptr) return NVJPEG_STATUS_SUCCESS;
    // chroma upsampled by interpolation, as libjpeg's default ("fancy")
    // upsampling does; without it nvJPEG differed from libjpeg by up to 54
    // levels at colour edges on the smoke fixture (PERF.md)
    nvjpegStatus_t rc = nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT, nullptr, nullptr,
                                       NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION, &g_handle);
    if (rc != NVJPEG_STATUS_SUCCESS) { g_handle = nullptr; return rc; }
    rc = nvjpegJpegStateCreate(g_handle, &g_state);
    if (rc != NVJPEG_STATUS_SUCCESS) {
        nvjpegDestroy(g_handle);
        g_handle = nullptr;
        g_state = nullptr;
    }
    return rc;
}

}  // namespace

extern "C" {

// Width and height of the image's first component; returns the nvJPEG
// status (0 on success).
int mggan_jpeg_size(const unsigned char* data, size_t length, int* width, int* height) {
    std::lock_guard<std::mutex> lock(g_mutex);
    int rc = ensure_handle();
    if (rc != NVJPEG_STATUS_SUCCESS) return rc;
    int n_components = 0;
    nvjpegChromaSubsampling_t subsampling;
    int widths[NVJPEG_MAX_COMPONENT] = {0};
    int heights[NVJPEG_MAX_COMPONENT] = {0};
    rc = nvjpegGetImageInfo(g_handle, data, length, &n_components, &subsampling, widths,
                            heights);
    *width = widths[0];
    *height = heights[0];
    return rc;
}

// Decode into out_rgb (device memory, height rows of pitch bytes) as
// interleaved RGB on `stream`; returns the nvJPEG status.
int mggan_jpeg_decode_rgb(const unsigned char* data, size_t length, void* out_rgb,
                          int pitch, void* stream) {
    std::lock_guard<std::mutex> lock(g_mutex);
    int rc = ensure_handle();
    if (rc != NVJPEG_STATUS_SUCCESS) return rc;
    nvjpegImage_t image = {};
    image.channel[0] = static_cast<unsigned char*>(out_rgb);
    image.pitch[0] = static_cast<size_t>(pitch);
    return nvjpegDecode(g_handle, g_state, data, length, NVJPEG_OUTPUT_RGBI, &image,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
