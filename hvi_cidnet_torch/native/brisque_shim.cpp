// Native BRISQUE scorer backed by the system OpenCV quality module.
//
// A copy of hvi_cidnet_tpu/native/brisque_shim.cpp for hvi_cidnet_torch.
// The reference scores BRISQUE through the imquality package
// (measure_niqe_bris.py:4,26), whose bundled LIVE-trained SVR is not part of
// this repository. OpenCV 4's contrib quality module (libopencv_quality)
// implements the same algorithm and ships a LIVE-R2-trained model + range
// file (share/opencv4/quality/brisque_model_live.yml, brisque_range_live.yml):
// the same algorithm trained on the same corpus (SROCC -0.8424 vs the
// original's -0.8354 on TID2008, per the OpenCV header). This shim exposes
// that scorer (and its feature extractor, a parity oracle for the numpy
// features in metrics/brisque.py) through a minimal C ABI loaded via ctypes.
//
// Build (hvi_cidnet_torch/metrics/brisque_cv.py does this at first use, into
// build/brisque/ at the repository root):
//   g++ -O2 -shared -fPIC -I/usr/include/opencv4 brisque_shim.cpp \
//       -lopencv_quality -lopencv_ml -lopencv_imgproc -lopencv_core \
//       -o libbrisque_shim.so

#include <opencv2/core.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/quality/qualitybrisque.hpp>

#include <cstring>

namespace {

// Wrap caller memory as a Mat and convert RGB -> BGR (OpenCV's native
// channel order; QualityBRISQUE grayscales BGR input internally).
cv::Mat to_bgr(const unsigned char* data, int h, int w, int channels) {
    if (channels == 1) {
        return cv::Mat(h, w, CV_8UC1, const_cast<unsigned char*>(data)).clone();
    }
    cv::Mat rgb(h, w, CV_8UC3, const_cast<unsigned char*>(data));
    cv::Mat bgr;
    cv::cvtColor(rgb, bgr, cv::COLOR_RGB2BGR);
    return bgr;
}

}  // namespace

extern "C" {

// Score an 8-bit RGB (channels=3) or grayscale (channels=1) image.
// Returns 0 on success with *out_score set; -1 on any OpenCV error.
int brisque_score_u8(const unsigned char* data, int h, int w, int channels,
                     const char* model_path, const char* range_path,
                     double* out_score) {
    try {
        cv::Mat img = to_bgr(data, h, w, channels);
        cv::Scalar s = cv::quality::QualityBRISQUE::compute(
            img, cv::String(model_path), cv::String(range_path));
        *out_score = s[0];
        return 0;
    } catch (...) {
        return -1;
    }
}

// The 36-dim unscaled BRISQUE feature vector (oracle for the Python arm).
// out36 must hold 36 floats.  Returns 0 on success, -1 on error.
int brisque_features_u8(const unsigned char* data, int h, int w, int channels,
                        float* out36) {
    try {
        cv::Mat img = to_bgr(data, h, w, channels);
        cv::Mat feats;
        cv::quality::QualityBRISQUE::computeFeatures(img, feats);
        cv::Mat f32;
        feats.convertTo(f32, CV_32F);
        if (f32.total() < 36) return -1;
        std::memcpy(out36, f32.ptr<float>(0), 36 * sizeof(float));
        return 0;
    } catch (...) {
        return -1;
    }
}

}  // extern "C"
