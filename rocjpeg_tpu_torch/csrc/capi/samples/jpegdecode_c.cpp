// jpegdecode_c — C-ABI sample: the jpegDecode workload driven through
// librocjpeg_tpu_torch.so (the analog of samples/jpegDecode/jpegdecode.cpp built
// against librocjpeg.so). Demonstrates that existing rocJPEG C call sites
// (create -> stream parse -> get info -> decode -> save) port unchanged.
//
// Usage: jpegdecode_c -i <file.jpg> [-fmt native|yuv_planar|y|rgb|rgb_planar]
//                     [-o <rawfile>] [-crop l,t,r,b]
// Exits 0 on success (the reference CTest pass criterion, SURVEY.md §4).

#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "../include/rocjpeg_tpu.h"

#define CHECK(call)                                                        \
    do {                                                                   \
        RocJpegStatus s_ = (call);                                         \
        if (s_ != ROCJPEG_STATUS_SUCCESS) {                                \
            std::fprintf(stderr, "error: %s failed: %s\n", #call,          \
                         rocJpegGetErrorName(s_));                         \
            return 1;                                                      \
        }                                                                  \
    } while (0)

namespace {

struct PlaneDims {
    uint32_t width_bytes[ROCJPEG_MAX_COMPONENT] = {0, 0, 0, 0};
    uint32_t heights[ROCJPEG_MAX_COMPONENT] = {0, 0, 0, 0};
};

// Channel layout per output format / subsampling — the caller-side buffer
// sizing the reference samples do in GetChannelPitchAndSizes
// (samples/rocjpeg_samples_utils.h:318-399), with tight pitches.
PlaneDims ComputePlanes(RocJpegOutputFormat fmt,
                        RocJpegChromaSubsampling css, uint32_t w, uint32_t h,
                        const uint32_t widths[4], const uint32_t heights[4]) {
    PlaneDims d;
    switch (fmt) {
        case ROCJPEG_OUTPUT_RGB:
            d.width_bytes[0] = 3 * w;
            d.heights[0] = h;
            break;
        case ROCJPEG_OUTPUT_RGB_PLANAR:
            for (int i = 0; i < 3; ++i) {
                d.width_bytes[i] = w;
                d.heights[i] = h;
            }
            break;
        case ROCJPEG_OUTPUT_Y:
            d.width_bytes[0] = w;
            d.heights[0] = h;
            break;
        case ROCJPEG_OUTPUT_YUV_PLANAR:
            for (int i = 0; i < 3; ++i) {
                d.width_bytes[i] = widths[i];
                d.heights[i] = heights[i];
            }
            break;
        case ROCJPEG_OUTPUT_NATIVE:
        default:
            if (css == ROCJPEG_CSS_422) {  // packed YUYV
                d.width_bytes[0] = 2 * w;
                d.heights[0] = h;
            } else if (css == ROCJPEG_CSS_420) {  // NV12
                d.width_bytes[0] = w;
                d.heights[0] = h;
                d.width_bytes[1] = widths[1] * 2;  // interleaved UV
                d.heights[1] = heights[1];
            } else if (css == ROCJPEG_CSS_400) {
                d.width_bytes[0] = w;
                d.heights[0] = h;
            } else {  // 444 / 440: three planes
                for (int i = 0; i < 3; ++i) {
                    d.width_bytes[i] = widths[i];
                    d.heights[i] = heights[i];
                }
            }
            break;
    }
    return d;
}

}  // namespace

int main(int argc, char **argv) {
    std::string input, output;
    RocJpegOutputFormat fmt = ROCJPEG_OUTPUT_NATIVE;
    int crop[4] = {0, 0, 0, 0};
    for (int i = 1; i < argc; ++i) {
        std::string a = argv[i];
        if (a == "-i" && i + 1 < argc) {
            input = argv[++i];
        } else if (a == "-o" && i + 1 < argc) {
            output = argv[++i];
        } else if (a == "-fmt" && i + 1 < argc) {
            std::string f = argv[++i];
            if (f == "native") fmt = ROCJPEG_OUTPUT_NATIVE;
            else if (f == "yuv_planar") fmt = ROCJPEG_OUTPUT_YUV_PLANAR;
            else if (f == "y") fmt = ROCJPEG_OUTPUT_Y;
            else if (f == "rgb") fmt = ROCJPEG_OUTPUT_RGB;
            else if (f == "rgb_planar") fmt = ROCJPEG_OUTPUT_RGB_PLANAR;
            else { std::fprintf(stderr, "unknown -fmt %s\n", f.c_str()); return 1; }
        } else if (a == "-crop" && i + 1 < argc) {
            if (std::sscanf(argv[++i], "%d,%d,%d,%d", &crop[0], &crop[1],
                            &crop[2], &crop[3]) != 4) {
                std::fprintf(stderr, "bad -crop\n");
                return 1;
            }
        } else {
            std::fprintf(stderr, "usage: %s -i file.jpg [-fmt f] [-o out] [-crop l,t,r,b]\n",
                         argv[0]);
            return 1;
        }
    }
    if (input.empty()) {
        std::fprintf(stderr, "error: -i required\n");
        return 1;
    }

    FILE *fp = std::fopen(input.c_str(), "rb");
    if (fp == nullptr) {
        std::fprintf(stderr, "error: cannot open %s\n", input.c_str());
        return 1;
    }
    std::fseek(fp, 0, SEEK_END);
    long n = std::ftell(fp);
    std::fseek(fp, 0, SEEK_SET);
    std::vector<unsigned char> data(static_cast<size_t>(n));
    if (std::fread(data.data(), 1, data.size(), fp) != data.size()) {
        std::fclose(fp);
        std::fprintf(stderr, "error: short read\n");
        return 1;
    }
    std::fclose(fp);

    RocJpegHandle handle = nullptr;
    RocJpegStreamHandle stream = nullptr;
    CHECK(rocJpegCreate(ROCJPEG_BACKEND_HARDWARE, 0, &handle));
    CHECK(rocJpegStreamCreate(&stream));
    CHECK(rocJpegStreamParse(data.data(), data.size(), stream));

    uint8_t num_components = 0;
    RocJpegChromaSubsampling css = ROCJPEG_CSS_UNKNOWN;
    uint32_t widths[4], heights[4];
    CHECK(rocJpegGetImageInfo(handle, stream, &num_components, &css, widths,
                              heights));
    std::printf("info: image %ux%u, %d components, subsampling %d\n",
                widths[0], heights[0], num_components, static_cast<int>(css));

    // Output dims honor a valid crop (invalid crop -> full frame, matching
    // src/rocjpeg_decoder.cpp:123-131); chroma/RGB planes scale accordingly.
    uint32_t out_w = widths[0], out_h = heights[0];
    const int cw = crop[2] - crop[0], ch = crop[3] - crop[1];
    if (cw > 0 && ch > 0 && static_cast<uint32_t>(cw) <= widths[0] &&
        static_cast<uint32_t>(ch) <= heights[0]) {
        out_w = static_cast<uint32_t>(cw);
        out_h = static_cast<uint32_t>(ch);
    }
    uint32_t out_widths[4], out_heights[4];
    for (int i = 0; i < 4; ++i) {
        out_widths[i] = widths[i] != 0
            ? widths[i] - (widths[0] - out_w) * widths[i] / widths[0] : 0;
        out_heights[i] = heights[i] != 0
            ? heights[i] - (heights[0] - out_h) * heights[i] / heights[0] : 0;
    }
    PlaneDims dims = ComputePlanes(fmt, css, out_w, out_h, out_widths,
                                   out_heights);

    RocJpegImage image = {};
    std::vector<std::vector<uint8_t>> buffers(ROCJPEG_MAX_COMPONENT);
    for (int i = 0; i < ROCJPEG_MAX_COMPONENT; ++i) {
        if (dims.width_bytes[i] == 0) continue;
        buffers[i].resize(static_cast<size_t>(dims.width_bytes[i]) *
                          dims.heights[i]);
        image.channel[i] = buffers[i].data();
        image.pitch[i] = dims.width_bytes[i];
    }

    RocJpegDecodeParams params = {};
    params.output_format = fmt;
    params.crop_rectangle.left = static_cast<int16_t>(crop[0]);
    params.crop_rectangle.top = static_cast<int16_t>(crop[1]);
    params.crop_rectangle.right = static_cast<int16_t>(crop[2]);
    params.crop_rectangle.bottom = static_cast<int16_t>(crop[3]);

    auto t0 = std::chrono::steady_clock::now();
    CHECK(rocJpegDecode(handle, stream, &params, &image));
    double ms = std::chrono::duration<double, std::milli>(
                    std::chrono::steady_clock::now() - t0).count();
    std::printf("info: decoded in %.3f ms\n", ms);

    if (!output.empty()) {
        FILE *out = std::fopen(output.c_str(), "wb");
        if (out == nullptr) {
            std::fprintf(stderr, "error: cannot open %s\n", output.c_str());
            return 1;
        }
        for (int i = 0; i < ROCJPEG_MAX_COMPONENT; ++i) {
            if (!buffers[i].empty()) {
                std::fwrite(buffers[i].data(), 1, buffers[i].size(), out);
            }
        }
        std::fclose(out);
        std::printf("info: wrote %s\n", output.c_str());
    }

    CHECK(rocJpegStreamDestroy(stream));
    CHECK(rocJpegDestroy(handle));
    std::printf("info: success\n");
    return 0;
}
